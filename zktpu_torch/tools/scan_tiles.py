"""Time the field-scan kernel (kernel A) at other block sizes, chunks and
one-block limits.

    python -m zktpu_torch.tools.scan_tiles [--reps 20]

csrc/field_ops.cu fixes the threads of a block (ZK_SCAN_THREADS); the
wrapper (fields/field_kernel.py) fixes the rest of the design: the rows a
thread takes in a tile of the three-pass scan (SCAN_CHUNK), the largest n
that one block per column scans in one launch by the product
(ONE_BLOCK_MAX_MUL) and by the add or sum (ONE_BLOCK_MAX_ADD), and the rows
a thread of powers takes (POWERS_CHUNK).
For each thread count in THREADS this tool builds its own copy of
field_ops.cu with -DZK_SCAN_THREADS (one nvcc per design, in parallel, into
build/zktpu_torch/), and for each wrapper design in SIZES launches it
through the port's wrappers at the paths' shapes: the round-2 grand product
and the reverse cumsum of divide_by_linear (2^14 x 1, Fr), the sum of
evaluate_many (axis 1 of (8, 2^14 + 3, 8)), the batch inversion of round 2
(2^14, Fr) and of Srs.g1_affine (2^20, Fq), and the powers of the 8n coset
(2^17, Fr).  Each result must equal the library's words.  One JSON line per
design and shape: registers, local bytes (spills), launches, ms per call
(CUDA events, the wrapper included) and the device time per call
(torch.profiler: the kernels and the copy, no host time).
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
from zktpu_torch.fields import field_kernel as fk
from zktpu_torch.fields.fp import field
from zktpu_torch.fields.host import FQ, FR

THREADS = (128, 256, 512, 1024)
# (SCAN_CHUNK, ONE_BLOCK_MAX_MUL, ONE_BLOCK_MAX_ADD, POWERS_CHUNK); 0 means
# one block only up to one tile.  The library's are the module constants of
# fields/field_kernel.py, (8, 2^12, 2^15, 8).
SIZES = ((4, 0, 0, 4), (8, 0, 0, 8), (16, 0, 0, 16), (8, 1 << 12, 1 << 15, 8), (8, 1 << 14, 1 << 15, 8))
_NAMES = ("zk_field_scan", "zk_field_scan_threads", "zk_field_powers", "zk_field_batch_inv", "zk_field_addsub",
          "zk_field_ops_attrs")


def build_designs(threads=THREADS) -> dict:
    """{threads: path} of field_ops.cu built once per thread count, all nvcc at once."""
    src = os.path.join(cuda_lib.CSRC_DIR, "field_ops.cu")
    h = hashlib.sha256(" ".join(cuda_lib.NVCC_FLAGS).encode())
    for name in ("field.cuh", "field_ops.cuh", "field_ops.cu"):
        with open(os.path.join(cuda_lib.CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    paths = {t: os.path.join(cuda_lib.BUILD_DIR, f"libscan_t{t}-{h.hexdigest()[:16]}.so") for t in threads}
    nvcc = cuda_lib.find_nvcc()
    procs = {}
    for t, path in paths.items():
        if not os.path.exists(path):
            procs[t] = subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, f"-DZK_SCAN_THREADS={t}", "-shared", "-o", path,
                                         src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for t, p in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            raise cuda_lib.KernelBuildError(f"nvcc for {t} scan threads failed ({p.returncode}):\n{err}")
    return paths


@contextlib.contextmanager
def _design(path, sizes):
    """Inside this block the field wrappers launch the library at `path` with the wrapper sizes `sizes`."""
    lib = ctypes.CDLL(path)
    for name in _NAMES:
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    names = ("SCAN_CHUNK", "ONE_BLOCK_MAX_MUL", "ONE_BLOCK_MAX_ADD", "POWERS_CHUNK")
    saved = cuda_lib.load, {k: getattr(fk, k) for k in names}
    cuda_lib.load = lambda: lib
    for k, v in zip(names, sizes):
        setattr(fk, k, v)
    try:
        yield lib
    finally:
        cuda_lib.load = saved[0]
        for k, v in saved[1].items():
            setattr(fk, k, v)


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


def _device_ms(fn, reps: int) -> float:
    """Device time per call from torch.profiler: the kernels and copies that
    take no CPU time themselves (as tools/prof_prove.py counts them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_cpu_time_total == 0]
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def _rows(f, gen, n, cols=1):
    """(n, cols, L) canonical limbs, none zero (the top limb below p's)."""
    L, p = f.num_limbs, f.spec.modulus
    t = torch.randint(-(1 << 31), 1 << 31, (n, cols, L), dtype=torch.int64, device=f.device, generator=gen)
    t[..., L - 1] &= (1 << ((p.bit_length() - 1) % 32)) - 1
    t[..., 0] |= 1
    return t.to(torch.int32)


def cases(device, log_n: int = 14, fq_log_n: int = 20):
    """(name, field, call) at the paths' shapes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(20261017)
    fr, fq = field(FR, device), field(FQ, device)
    n = 1 << log_n
    x = _rows(fr, gen, n)[:, 0]
    y = _rows(fr, gen, n + 3, 8).transpose(0, 1)
    d = _rows(fq, gen, 1 << fq_log_n)[:, 0]
    return (
        (f"cumprod Fr ({n}, 8)", FR, lambda: fr.cumprod(x)),
        (f"cumsum reverse Fr ({n}, 8)", FR, lambda: fr.cumsum(x, reverse=True)),
        (f"sum axis 1 Fr (8, {n + 3}, 8)", FR, lambda: fr.sum(y, axis=1)),
        (f"batch_inv Fr ({n}, 8)", FR, lambda: fr.batch_inv(x, FR.inv)),
        (f"powers Fr {8 * n}", FR, lambda: fr.powers(0x1234567, 8 * n)),
        (f"batch_inv Fq ({1 << fq_log_n}, 12)", FQ, lambda: fq.batch_inv(d, FQ.inv)),
    )


def time_designs(reps: int = 20, threads=THREADS, sizes=SIZES, device=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    libs = build_designs(threads)
    rows = []
    for name, spec, call in cases(device):
        want = call()  # the library's design
        for t, path in libs.items():
            for size in sizes:
                with _design(path, size) as lib:
                    before = fk.launches["field_scan"][spec.name]
                    got = call()
                    launched = fk.launches["field_scan"][spec.name] - before
                    assert torch.equal(got, want), f"{name}: the design {t} threads {size} disagrees"
                    out = (ctypes.c_int * 3)()
                    cuda_lib.check(lib.zk_field_ops_attrs(0, out), "field_scan attributes")
                    row = {"case": name, "threads": t, "scan_chunk": size[0], "one_block_max_mul": size[1],
                           "one_block_max_add": size[2], "powers_chunk": size[3], "launches": launched,
                           "registers": out[0], "local_bytes": out[1], "ms": _ms(call, reps),
                           "device_ms": _device_ms(call, reps)}
                rows.append(row)
                print(json.dumps(row), flush=True)
        del want
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_tiles: no CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    time_designs(args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
