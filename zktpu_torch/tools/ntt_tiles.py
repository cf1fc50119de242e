"""Time the NTT kernel at other tile sizes, block sizes and occupancies.

    python -m zktpu_torch.tools.ntt_tiles [--reps 30] [--field fr|goldilocks]

csrc/ntt.cu hard-codes its design: the tile size, the threads of a block,
the minimum of blocks per SM that the launch bound asks for (which caps the
registers) and the fewest columns of a later pass's tile.  For each design
in DESIGNS (Fr) or GL_DESIGNS (Goldilocks) this tool builds its own copy of
ntt.cu with -DZK_NTT_LOG_TILE (or -DZK_NTT_LOG_TILE_L2), -DZK_NTT_THREADS,
-DZK_NTT_MIN_BLOCKS and -DZK_NTT_LOG_MIN_COLS (or its _L2 twin) (one nvcc
per design, in parallel, into build/zktpu_torch/), launches it through the
port's wrapper at the paths' shapes (Fr: the 8n coset transform at 2^14
gates, 2^17 x batch 7, and 2^20 x 1; Goldilocks: FRI's coset transforms at
2^20, 2^16 and 2^12), checks that it gives the library's words, and prints
one JSON line per design and shape: registers, local bytes (spills),
passes, ms per call with CUDA events and the share of the integer bound.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess

import torch

from zktpu_torch import cuda_lib
from zktpu_torch.fields.host import FR, GOLDILOCKS
from zktpu_torch.poly import ntt_kernel
from zktpu_torch.poly.domain import Radix2Domain

# (log2 tile, threads a block, minimum blocks per SM, log2 fewest columns);
# the library's is (9, 128, 8, 3)
DESIGNS = ((11, 512, 2, 3), (10, 256, 4, 3), (10, 256, 4, 2), (10, 128, 7, 3), (9, 128, 8, 3), (9, 128, 8, 2),
           (9, 256, 4, 3), (8, 64, 16, 3), (8, 64, 16, 2))
SHAPES = ((17, 7), (20, 1))  # (log n, batch)
# Goldilocks: the library's is (10, 128, 8, 4); 8 KB of shared memory a block
# at 2^10, 16 KB at 2^11, 32 KB at 2^12, 64 KB at 2^13
GL_DESIGNS = ((11, 128, 8, 4), (11, 256, 4, 4), (11, 128, 8, 3), (12, 256, 4, 4), (12, 512, 2, 4),
              (13, 512, 2, 4), (10, 128, 8, 4), (9, 128, 8, 3))
GL_SHAPES = ((20, 1), (16, 1), (12, 1))
# 32-bit integer multiply-adds: 64 per clock per SM x 132 SMs x 1.98 GHz
# (NVIDIA H100 SXM); a product is 2 x (2 L^2 + L) of them.
IMAD_PER_S = 132 * 64 * 1.98e9


def _product_imads(spec) -> int:
    L = spec.num_digits // 2
    return 2 * (2 * L * L + L)


def build_designs(designs, spec=FR) -> dict:
    """{design: path} of ntt.cu built once per design, all nvcc at once."""
    src = os.path.join(cuda_lib.CSRC_DIR, "ntt.cu")
    h = hashlib.sha256(" ".join(cuda_lib.NVCC_FLAGS).encode())
    for name in ("field.cuh", "ntt.cuh", "ntt.cu"):
        with open(os.path.join(cuda_lib.CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    suffix = "_L2" if spec is GOLDILOCKS else ""
    h.update(suffix.encode())
    paths = {d: os.path.join(cuda_lib.BUILD_DIR, "libntt{}_t{}_{}_{}_{}-{}.so".format(suffix, *d, h.hexdigest()[:16]))
             for d in designs}
    nvcc = cuda_lib.find_nvcc()
    procs = {}
    for (tile, threads, blocks, cols), path in paths.items():
        if not os.path.exists(path):
            flags = [f"-DZK_NTT_LOG_TILE{suffix}={tile}", f"-DZK_NTT_THREADS={threads}",
                     f"-DZK_NTT_MIN_BLOCKS={blocks}", f"-DZK_NTT_LOG_MIN_COLS{suffix}={cols}"]
            procs[(tile, threads, blocks, cols)] = subprocess.Popen(
                [nvcc, *cuda_lib.NVCC_FLAGS, *flags, "-shared", "-o", path, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for d, p in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            raise cuda_lib.KernelBuildError(f"nvcc for the NTT design {d} failed ({p.returncode}):\n{err}")
    return paths


@contextlib.contextmanager
def _library(path):
    """The NTT wrapper launches the kernel of the library at `path` inside this block."""
    lib = ctypes.CDLL(path)
    for name in ("zk_ntt", "zk_ntt_attrs"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    saved = cuda_lib.load
    cuda_lib.load = lambda: lib
    try:
        yield
    finally:
        cuda_lib.load = saved


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


def time_designs(reps: int = 30, designs=None, device=None, spec=FR) -> list[dict]:
    """Each design at the paths' shapes of `spec`: Fr's plain transforms, or
    Goldilocks' coset transforms (FRI's layers)."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    gl = spec is GOLDILOCKS
    designs = designs or (GL_DESIGNS if gl else DESIGNS)
    libs = build_designs(designs, spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    L = spec.num_digits // 2
    rows = []
    for log_n, batch in GL_SHAPES if gl else SHAPES:
        n = 1 << log_n
        dom = Radix2Domain(spec, n, device=device)
        x = torch.randint(-(1 << 31), 1 << 31, (batch, n, L), dtype=torch.int64, device=device, generator=gen)
        x[..., L - 1] &= (1 << (31 if gl else 29)) - 1  # canonical: below p
        x = x.to(torch.int32)
        fin = dom.offset_powers(spec.generator) if gl else None

        def run():
            return ntt_kernel.ntt(x, dom._fwd_tw, False, fin, None, spec)

        want = run()  # the library's design
        bound_ms = batch * ((n // 2) * log_n + (n if gl else 0)) * _product_imads(spec) / IMAD_PER_S * 1e3
        for design, path in libs.items():
            with _library(path):
                before = ntt_kernel.ntt.launches[spec.name]
                got = run()
                passes = ntt_kernel.ntt.launches[spec.name] - before
                assert torch.equal(got, want), f"the NTT design {design} disagrees with the library's"
                row = {"field": spec.name, "log_tile": design[0], "threads": design[1], "min_blocks": design[2],
                       "log_min_cols": design[3], "log_n": log_n,
                       "batch": batch, "passes": passes, **ntt_kernel.kernel_attrs(spec),
                       "ms": _ms(run, reps)}
            row["bound_ms"] = bound_ms
            row["bound_share"] = bound_ms / row["ms"]
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, want, dom
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--field", choices=("fr", "goldilocks"), default="fr")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ntt_tiles: no CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    time_designs(args.reps, spec=GOLDILOCKS if args.field == "goldilocks" else FR)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
