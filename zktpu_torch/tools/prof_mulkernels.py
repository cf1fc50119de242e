"""Microbenchmark of the Montgomery multiply body on one CUDA GPU.

    python -m zktpu_torch.tools.prof_mulkernels [N] [variant...]
    CHAIN=12 python -m zktpu_torch.tools.prof_mulkernels 65536 base

The port's counterpart of tools/prof_mulkernels.py.  Each variant runs CHAIN
chained products a = a * b * R^{-1} inside ONE kernel launch (kernel 5,
fields/mont_kernel.py::mont_mul_chain), so the number measures the multiply
body, not device memory or launches.  N defaults to 2^16 and CHAIN to 12;
the field is Fq, as in the original (``run`` takes another spec).

Variants (the original's three bodies):
  base  the CIOS carry-chain product of csrc/field.cuh, as every other
        kernel runs it (csrc/mont_mul.cu);
  mxu   the two constant convolutions, t * (-p^{-1}) mod R and m * p, as u8
        tensor-core products (a warpgroup's wgmma m64nNk32), the variable
        one on the integer multiply-add pipe (csrc/mont_mma.cu);
  f32   the same, with the variable convolution as FP32 FMAs over 8-bit
        digits.
mxu and f32 need a field of at least 16 digits (Fr, Fq); Goldilocks raises
ValueError.

Each line gives the first call's seconds (build included), the best of three
timed calls (CUDA events, the wrapper included) per chained product, and the
products per second.  Every variant's output is checked first against the
plain chained product of the base body on the same inputs and device
(``mont_mul_chain_plain``; "MATCH" or an error: the three compute the same
function), so the tool launches no kernel but the chained ones.  Without a
CUDA device it raises.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..fields.fp import field, norm_device
from ..fields.host import FQ
from ..fields.mont_kernel import CHAIN_VARIANTS, mont_mul_chain, mont_mul_chain_plain
from ..fields.mont_mats import mma_issued, mma_products

VARIANTS = CHAIN_VARIANTS

# The card's peak rates for the bounds (NVIDIA H100 SXM at its 700 W limit,
# 132 SMs at 1.98 GHz): HBM3 3.35 TB/s; 32-bit integer multiply-adds 64 a
# clock per SM; FP32 FMAs 128 a clock per SM (the data sheet's 67 TFLOP/s
# counts two flops a FMA); u8 multiply-accumulates on the tensor cores at
# the data sheet's dense 1,979 int8 TOP/s, two operations a MAC.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
FFMA_PER_S = 132 * 128 * 1.98e9
TENSOR_U8_MAC_PER_S = 1979e12 / 2


def chain_bound(spec, variant: str, n: int, chain: int) -> dict:
    """The least time of `chain` products of n elements in one body: the
    bytes (a and b read, the result written once) over HBM, or the busiest
    pipe: "imad" (base: a CIOS product, 2 (2L^2 + L) multiply-adds; mxu: the
    L carry-chain rows of t = x y, 2 L^2), "ffma" (f32: 4 D^2 a product) or
    "tensor" (mxu, f32: the u8 MACs of the band, fields/mont_mats.py's
    mma_products per 16 elements).  For mxu and f32, "tensor_issued_ms" is
    the tensor pipe's time for the MACs the kernel issues (mma_issued: wgmma
    multiplies whole N ranges, the band's zero blocks too)."""
    L, D = spec.num_digits // 2, spec.num_digits
    t_bytes = 3 * n * 4 * L / HBM_BYTES_PER_S
    if variant == "base":
        pipes = {"imad": 2 * (2 * L * L + L) / IMAD_PER_S}
    else:
        pipes = {"tensor": mma_products(spec) * 16 * 8 * 32 / 16 / TENSOR_U8_MAC_PER_S}
        pipes.update({"imad": 2 * L * L / IMAD_PER_S} if variant == "mxu" else {"ffma": 4 * D * D / FFMA_PER_S})
    t_ops = max(pipes.values()) * n * chain
    out = {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_pipe": max(pipes, key=pipes.get)}
    if variant != "base":
        out["tensor_issued_ms"] = mma_issued(spec) / TENSOR_U8_MAC_PER_S * n * chain * 1e3
    return out


def rand_elems(spec, n: int, device, seed: int = 0) -> torch.Tensor:
    """1024 random elements (numpy seed), tiled to n rows, Montgomery limbs."""
    rng = np.random.default_rng(seed)
    nbytes = (spec.modulus.bit_length() - 1) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % spec.modulus for _ in range(min(n, 1024))]
    base = field(spec, device).encode_ints(vals)
    return base.repeat(-(-n // base.shape[0]), 1)[:n].contiguous()


def run_variant(variant: str, a: torch.Tensor, b: torch.Tensor, spec, chain: int, iters: int = 3) -> dict:
    """Time one variant on (a, b); returns seconds of the first call, ms per
    chained product and products per second, after checking the output."""
    n = a.shape[0]
    t0 = time.perf_counter()
    out = mont_mul_chain(spec, a, b, chain, variant)
    torch.cuda.synchronize(a.device)
    first_s = time.perf_counter() - t0
    if not torch.equal(out, mont_mul_chain_plain(spec, a, b, chain)):
        raise AssertionError(f"{variant}: the chained kernel differs from {chain} plain (base) products")
    best = float("inf")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        start.record()
        mont_mul_chain(spec, a, b, chain, variant)
        end.record()
        torch.cuda.synchronize(a.device)
        best = min(best, start.elapsed_time(end) / 1e3)
    per_mul = best / chain
    return {"variant": variant, "n": n, "chain": chain, "first_s": first_s,
            "ms_per_mul": per_mul * 1e3, "mmul_per_s": n / per_mul / 1e6}


def run(n: int = 1 << 16, chain: int = 12, spec=FQ, variants=VARIANTS, device=None) -> list[dict]:
    device = norm_device(device)
    if device.type != "cuda":
        raise ValueError("prof_mulkernels times the CUDA kernel; it needs a CUDA device")
    a, b = rand_elems(spec, n, device, 0), rand_elems(spec, n, device, 1)
    return [run_variant(v, a, b, spec, chain) for v in variants]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 1 << 16
    variants = argv[1:] or list(VARIANTS)
    chain = int(os.environ.get("CHAIN", 12))
    for r in run(n, chain, FQ, variants):
        print(
            f"{r['variant']:6s} N={n} CHAIN={chain} first={r['first_s']:6.2f}s  "
            f"{r['ms_per_mul']:8.4f} ms/mul  {r['mmul_per_s']:9.2f} Mmul/s  MATCH",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
