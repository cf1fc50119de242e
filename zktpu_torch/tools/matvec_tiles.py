"""Time Nova's matrix-vector kernel (matvec_fr) in other designs.

    python -m zktpu_torch.tools.matvec_tiles [--log-m 14] [--reps 5]

csrc/matvec.cu fixes the rows a block takes (ZK_MATVEC_ROWS), its threads
(ZK_MATVEC_THREADS) and the launch bound's minimum of blocks a SM
(ZK_MATVEC_MIN_BLOCKS, which caps the registers); the library's design is
(1, 128, 6).  This tool
builds its own copy of matvec.cu for each design in DESIGNS (one nvcc per
design, all at once, into build/zktpu_torch/), runs each on an (m, m + 3, 8)
matrix of random canonical words (Nova's shape at m = 2^log_m) and a random
z, and holds its words against the library's.  One JSON line per design
(the library's first): registers, local bytes (spills), ms per call (CUDA
events over --reps calls) and the share of the byte bound reached, beside
the card's name and power limit; then one line of the library kernel's SASS
opcodes (cuobjdump, g1_budgets.sass_counts).
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from zktpu_torch import cuda_lib
from zktpu_torch.nova import matvec_kernel
from zktpu_torch.tools.g1_budgets import sass_counts
from zktpu_torch.tools.trace import smi

# (rows, threads, min blocks a SM), beside the library's (1, 128, 6)
DESIGNS = ((1, 128, 8), (1, 256, 4), (2, 64, 8), (2, 128, 3), (2, 128, 4), (2, 128, 5), (2, 256, 2), (3, 128, 4),
           (4, 128, 3))
HBM_BYTES_PER_S = 3.35e12


def build_designs(designs=DESIGNS) -> dict:
    """{design: path} of matvec.cu built once per design, all nvcc at once."""
    return cuda_lib.build_variants("matvec.cu", {d: (f"-DZK_MATVEC_ROWS={d[0]}", f"-DZK_MATVEC_THREADS={d[1]}",
                                                     f"-DZK_MATVEC_MIN_BLOCKS={d[2]}") for d in designs})


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def operands(m: int, n: int, device, seed: int = 20261018):
    """An (m, n, 8) matrix and an (n, 8) vector of random canonical Fr words
    (the top limb below 2^30 < p's), made on the card."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    A = torch.randint(-(1 << 31), (1 << 31) - 1, (m, n, 8), dtype=torch.int32, device=device, generator=gen)
    z = torch.randint(-(1 << 31), (1 << 31) - 1, (n, 8), dtype=torch.int32, device=device, generator=gen)
    A[..., 7] &= (1 << 30) - 1
    z[..., 7] &= (1 << 30) - 1
    return A, z


def time_designs(log_m: int = 14, reps: int = 5, designs=DESIGNS, device=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    libs = build_designs(designs)
    m = 1 << log_m
    n = m + 3
    A, z = operands(m, n, device)
    bound_ms = (m * n + n + m) * 32 / HBM_BYTES_PER_S * 1e3
    want = matvec_kernel.matvec(A, z)
    rows = []
    for design, lib in [("library", cuda_lib.load())] + [(d, cuda_lib.load_variant(p)) for d, p in libs.items()]:
        got = matvec_kernel.run(lib, A, z)
        assert torch.equal(got, want), f"matvec design {design} differs from the library's"
        attrs = (ctypes.c_int * 5)()
        cuda_lib.check(lib.zk_matvec_attrs(attrs), "matvec attributes")
        ms = _ms(lambda: matvec_kernel.run(lib, A, z), reps)
        row = {"design": design if design == "library" else dict(zip(("rows", "threads", "min_blocks"), design)),
               "rows": attrs[3], "threads": attrs[4], "registers": attrs[0], "local_bytes": attrs[1],
               "shape": [m, n, 8], "ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms, "card": smi()}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-m", type=int, default=14)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matvec_tiles: no CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    time_designs(args.log_m, args.reps)
    sass = sass_counts(kernels=(("matvec_kernel", r"13matvec_kernel"),))["matvec_kernel"]
    print(json.dumps({"sass matvec_kernel": {k: v for k, v in sass.items() if k != "by_op"}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
