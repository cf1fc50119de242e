"""The yardstick: the MSM's work count and the card's integer peak.

MSM work depends only on the number of points N, the number of scalar
vectors K and the curve, never on how the program computes it:

- Pippenger's bucket method over 255-bit scalars with a window of c bits
  makes W(c) = ceil(255 / c) windows, each with N additions of a point into
  its bucket and 2 (2^c - 1) additions to sum the buckets, so
  adds(N) = min over c of W(c) (N + 2^(c+1) - 2); K vectors make K times that;
- each addition counts as a mixed addition, 11 field products (Renes,
  Costello, Batina 2015, Algorithm 8, a = 0, the two products by 3b left out);
- each product over Fq (12 words of 32 bits) counts as a CIOS Montgomery
  product's 2 * 12^2 + 12 = 300 word products, and each word product as two
  32-bit multiply-adds (its low and its high half).

The peak is 64 32-bit integer multiply-adds a clock per SM (NVIDIA CUDA C++
Programming Guide, "Arithmetic Instructions", throughput table, compute
capability 9.0) times the SM count times the SM clock's maximum, both read
from the run's own card.
"""
from __future__ import annotations

import subprocess

SCALAR_BITS = 255
MIXED_ADD_PRODUCTS = 11
FQ_WORDS = 12
WORD_PRODUCTS = 2 * FQ_WORDS * FQ_WORDS + FQ_WORDS
MULADDS_PER_WORD_PRODUCT = 2
MULADDS_PER_CLOCK_PER_SM = 64


def bucket_adds(n: int, k: int = 1) -> int:
    """The fewest additions Pippenger's bucket method makes for K MSMs of N points."""
    if n <= 0:
        return 0
    best = min(-(-SCALAR_BITS // c) * (n + (1 << (c + 1)) - 2) for c in range(1, 33))
    return k * best


def msm_muladds(n: int, k: int = 1) -> int:
    """32-bit integer multiply-adds of K MSMs of N points."""
    return bucket_adds(n, k) * MIXED_ADD_PRODUCTS * WORD_PRODUCTS * MULADDS_PER_WORD_PRODUCT


def smi(query: str) -> list[str]:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return [x.strip() for x in out.stdout.strip().splitlines()[0].split(",")]


def card() -> dict:
    """The card's name, SM count, maximum SM clock (MHz), power limit (W),
    and its integer multiply-add peak (per second)."""
    import torch

    props = torch.cuda.get_device_properties(0)
    clock_mhz, power_w = (float(x) for x in smi("clocks.max.sm,power.limit"))
    return {
        "name": torch.cuda.get_device_name(0),
        "sms": props.multi_processor_count,
        "clock_mhz": clock_mhz,
        "power_limit_w": power_w,
        "muladds_per_s": MULADDS_PER_CLOCK_PER_SM * props.multi_processor_count * clock_mhz * 1e6,
    }
