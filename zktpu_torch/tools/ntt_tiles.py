"""Time the Fr NTT kernel at other tile sizes, block sizes and occupancies.

    python -m zktpu_torch.tools.ntt_tiles [--reps 30]

csrc/ntt.cu hard-codes its design: the tile size, the threads of a block,
the minimum of blocks per SM that the launch bound asks for (which caps the
registers) and the fewest columns of a later pass's tile.  For each design
in DESIGNS this tool builds its own copy of ntt.cu with -DZK_NTT_LOG_TILE,
-DZK_NTT_THREADS, -DZK_NTT_MIN_BLOCKS and -DZK_NTT_LOG_MIN_COLS (one nvcc
per design, in parallel, into build/zktpu_torch/), launches it through
the port's wrapper at the paths' shapes (the 8n coset transform at 2^14
gates, 2^17 x batch 7, and 2^20 x 1), checks that it gives the library's
words, and prints one JSON line per design and shape: registers, local
bytes (spills), passes, ms per call with CUDA events and the share of the
integer bound.
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
from zktpu_torch.fields.host import FR
from zktpu_torch.poly import ntt_kernel
from zktpu_torch.poly.domain import Radix2Domain

# (log2 tile, threads a block, minimum blocks per SM, log2 fewest columns);
# the library's is (9, 128, 8, 3)
DESIGNS = ((11, 512, 2, 3), (10, 256, 4, 3), (10, 256, 4, 2), (10, 128, 7, 3), (9, 128, 8, 3), (9, 128, 8, 2),
           (9, 256, 4, 3), (8, 64, 16, 3), (8, 64, 16, 2))
SHAPES = ((17, 7), (20, 1))  # (log n, batch)
# 32-bit integer multiply-adds: 64 per clock per SM x 132 SMs x 1.98 GHz
# (NVIDIA H100 SXM); an Fr product is 2 x (2 x 8^2 + 8) of them.
IMAD_PER_S = 132 * 64 * 1.98e9
FR_PRODUCT_IMADS = 2 * (2 * 8 * 8 + 8)


def build_designs(designs) -> dict:
    """{design: path} of ntt.cu built once per design, all nvcc at once."""
    src = os.path.join(cuda_lib.CSRC_DIR, "ntt.cu")
    h = hashlib.sha256(" ".join(cuda_lib.NVCC_FLAGS).encode())
    for name in ("field.cuh", "ntt.cuh", "ntt.cu"):
        with open(os.path.join(cuda_lib.CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    paths = {d: os.path.join(cuda_lib.BUILD_DIR, "libntt_t{}_{}_{}_{}-{}.so".format(*d, h.hexdigest()[:16]))
             for d in designs}
    nvcc = cuda_lib.find_nvcc()
    procs = {}
    for (tile, threads, blocks, cols), path in paths.items():
        if not os.path.exists(path):
            flags = [f"-DZK_NTT_LOG_TILE={tile}", f"-DZK_NTT_THREADS={threads}", f"-DZK_NTT_MIN_BLOCKS={blocks}",
                     f"-DZK_NTT_LOG_MIN_COLS={cols}"]
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
    for name in ("zk_ntt_fr", "zk_ntt_attrs"):
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


def time_designs(reps: int = 30, designs=DESIGNS, device=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    libs = build_designs(designs)
    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    rows = []
    for log_n, batch in SHAPES:
        n = 1 << log_n
        dom = Radix2Domain(FR, n, device=device)
        x = torch.randint(-(1 << 31), 1 << 31, (batch, n, 8), dtype=torch.int64, device=device, generator=gen)
        x[..., 7] &= (1 << 29) - 1  # canonical: below 2^253 < p
        x = x.to(torch.int32)
        want = ntt_kernel.ntt(x, dom._fwd_tw, False)  # the library's design
        bound_ms = batch * (n // 2) * log_n * FR_PRODUCT_IMADS / IMAD_PER_S * 1e3
        for design, path in libs.items():
            with _library(path):
                before = ntt_kernel.ntt.launches
                got = ntt_kernel.ntt(x, dom._fwd_tw, False)
                passes = ntt_kernel.ntt.launches - before
                assert torch.equal(got, want), f"the NTT design {design} disagrees with the library's"
                row = {"log_tile": design[0], "threads": design[1], "min_blocks": design[2],
                       "log_min_cols": design[3], "log_n": log_n,
                       "batch": batch, "passes": passes, **ntt_kernel.kernel_attrs(),
                       "ms": _ms(lambda: ntt_kernel.ntt(x, dom._fwd_tw, False), reps)}
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ntt_tiles: no CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    time_designs(args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
