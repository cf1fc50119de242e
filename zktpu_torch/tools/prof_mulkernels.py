"""Microbenchmark of the Montgomery multiply body on one CUDA GPU.

    python -m zktpu_torch.tools.prof_mulkernels [N] [variant...]
    CHAIN=12 python -m zktpu_torch.tools.prof_mulkernels 65536 base

The port's counterpart of tools/prof_mulkernels.py.  Each variant runs CHAIN
chained products a = a * b * R^{-1} in registers inside ONE kernel launch
(kernel 5, fields/mont_kernel.py::mont_mul_chain), so the number measures the
multiply body, not device memory or launches.  N defaults to 2^16 and CHAIN
to 12; the field is Fq, as in the original (``run`` takes another spec).

Variants:
  base  the CIOS product of csrc/field.cuh, as the batched kernel runs it.
The original's "mxu" and "f32" variants (the constant convolutions as bf16
matrix products, the variable one as f32 FMAs) are not ported yet; asking for
them raises.

Each line gives the first call's seconds (build included), the best of three
timed calls (CUDA events) per chained product, and the products per second.
The output is checked against the plain chained product on the same inputs
and device (``mont_mul_chain_plain``; "MATCH" or an error), so the tool
launches no kernel but the chained one.  Without a CUDA device it raises.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..fields.fp import field, norm_device
from ..fields.host import FQ
from ..fields.mont_kernel import mont_mul_chain, mont_mul_chain_plain

VARIANTS = ("base",)


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
    if variant != "base":
        raise NotImplementedError(f"variant {variant!r} is not ported (ROADMAP: the mxu/f32 multiply bodies)")
    n = a.shape[0]
    t0 = time.perf_counter()
    out = mont_mul_chain(spec, a, b, chain)
    torch.cuda.synchronize(a.device)
    first_s = time.perf_counter() - t0
    if not torch.equal(out, mont_mul_chain_plain(spec, a, b, chain)):
        raise AssertionError(f"{variant}: the chained kernel differs from {chain} plain products")
    best = float("inf")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        start.record()
        mont_mul_chain(spec, a, b, chain)
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
