"""Time the field-scan kernel (kernel A) at other block sizes and tile
rules, beside another checkout's design.

    python -m zktpu_torch.tools.scan_tiles [--reps 20] [--parent DIR] [--quick]

csrc/field_ops.cuh fixes the threads of a block (ZK_SCAN_THREADS); the
wrapper (fields/field_kernel.py) fixes the rest of the design: the grid a
scan's chunk aims at (SCAN_GRID), the longest chunk (SCAN_CHUNK_MAX), the
rows a thread up to which a scan takes one tile (SCAN_ONE_TILE) and the rows
a thread of powers takes (POWERS_CHUNK).  For each thread count in
THREADS this tool builds its own copy of field_ops.cu with
-DZK_SCAN_THREADS (one nvcc per design, in parallel, into
build/zktpu_torch/), and for each wrapper design in SIZES launches it
through the port's wrappers at the paths' shapes (CASES): the round-2 grand
product and the reverse cumsum of divide_by_linear (2^14 x 1, Fr), the sums
of Poly.evaluate (axis 0 of 2^14 + 3) and evaluate_many (axis 1 of (8,
2^14 + 3, 8)), the batch inversion of round 2 (2^14, Fr) and of
Srs.g1_affine (2^20, Fq), and the powers of the 8n coset (2^17, Fr).  Then
the library alone at every size from 2^4 to 2^20 rows (cumprod and cumsum
over Fr, batch_inv over Fq).  With --parent it times another checkout's
package (a `git archive` of another commit unpacked under DIR; loaded by
tools/parent.py) at the same cases and sizes, in turns with the library
(library, parent, parent, library), and gives the device time of each of
its kernel launches at round 2's cumprod; each design's device time at
every size too.  Every result must equal the
library's words.  One JSON line per design and case: registers, local
bytes (spills), launches, ms per call (CUDA events, the wrapper included)
and the device time per call (torch.profiler: the kernels and the copy, no
host time), beside the card's name and power limit.  --quick: the library
and the parent only.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json

import torch

from zktpu_torch import cuda_lib
from zktpu_torch.fields import field_kernel as fk
from zktpu_torch.fields.fp import field
from zktpu_torch.fields.host import FQ, FR
from zktpu_torch.tools.trace import launch_device_ms, smi

THREADS = (128, 256)
# (SCAN_GRID, SCAN_CHUNK_MAX, SCAN_ONE_TILE, POWERS_CHUNK); the library's
# are the module constants of fields/field_kernel.py, (132, 32, 2, 8).
SIZES = ((132, 32, 2, 8), (264, 32, 2, 8), (132, 16, 2, 8), (132, 32, 4, 8), (264, 16, 4, 8))
_SIZE_NAMES = ("SCAN_GRID", "SCAN_CHUNK_MAX", "SCAN_ONE_TILE", "POWERS_CHUNK")
LOG_SIZES = (4, 6, 8, 10, 12, 13, 14, 15, 16, 18, 20)


def build_designs(threads=THREADS) -> dict:
    """{threads: path} of field_ops.cu built once per thread count, all nvcc at once."""
    return cuda_lib.build_variants("field_ops.cu", {t: (f"-DZK_SCAN_THREADS={t}",) for t in threads})


@contextlib.contextmanager
def _design(path, sizes):
    """Inside this block the field wrappers launch the library at `path` with the wrapper sizes `sizes`."""
    lib = cuda_lib.load_variant(path)
    saved = {k: getattr(fk, k) for k in _SIZE_NAMES}
    for k, v in zip(_SIZE_NAMES, sizes):
        setattr(fk, k, v)
    try:
        with cuda_lib.launching(lib):
            yield lib
    finally:
        for k, v in saved.items():
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


def cases(device, ops, log_n: int = 14, fq_log_n: int = 20):
    """(name, field, call) at the paths' shapes; ops: a module with scan,
    field_sum, powers and batch_inv (fields/field_kernel.py, this checkout's
    or another's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(20261017)
    fr, fq = field(FR, device), field(FQ, device)
    n = 1 << log_n
    x = _rows(fr, gen, n)[:, 0]
    y = _rows(fr, gen, n + 3, 8)
    d = _rows(fq, gen, 1 << fq_log_n)[:, 0]
    return (
        (f"cumprod Fr ({n}, 8)", FR, lambda: ops.scan(fr, x, ops.OP_MUL)),
        (f"cumsum reverse Fr ({n}, 8)", FR, lambda: ops.scan(fr, x, ops.OP_ADD, 0, True)),
        (f"sum axis 0 Fr ({n + 3}, 8)", FR, lambda: ops.field_sum(fr, y[:, 0])),
        (f"sum axis 1 Fr (8, {n + 3}, 8)", FR, lambda: ops.field_sum(fr, y.transpose(0, 1), 1)),
        (f"batch_inv Fr ({n}, 8)", FR, lambda: ops.batch_inv(fr, x, FR.inv)),
        (f"powers Fr {8 * n}", FR, lambda: ops.powers(fr, 0x1234567, 8 * n)),
        (f"batch_inv Fq ({1 << fq_log_n}, 12)", FQ, lambda: ops.batch_inv(fq, d, FQ.inv)),
    )


def size_cases(device, ops, log_sizes=LOG_SIZES):
    """cumprod and cumsum over Fr and batch_inv over Fq at each size 2^k."""
    gen = torch.Generator(device=device)
    gen.manual_seed(20261019)
    fr, fq = field(FR, device), field(FQ, device)
    out = []
    for k in log_sizes:
        x = _rows(fr, gen, 1 << k)[:, 0]
        d = _rows(fq, gen, 1 << k)[:, 0]
        out += [(f"cumprod Fr 2^{k}", FR, lambda x=x: ops.scan(fr, x, ops.OP_MUL)),
                (f"cumsum Fr 2^{k}", FR, lambda x=x: ops.scan(fr, x, ops.OP_ADD)),
                (f"batch_inv Fq 2^{k}", FQ, lambda d=d: ops.batch_inv(fq, d, FQ.inv))]
    return out


def _launched(ops, spec, call):
    before = ops.launches["field_scan"][spec.name]
    got = call()
    return got, ops.launches["field_scan"][spec.name] - before


def _attrs(lib) -> dict:
    out = (ctypes.c_int * 3)()
    cuda_lib.check(lib.zk_field_ops_attrs(0, out), "field_scan attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2]}


def time_designs(reps: int = 20, threads=THREADS, sizes=SIZES, parent: str | None = None, quick: bool = False,
                 device=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    card = smi()
    par = None
    if parent:
        from zktpu_torch.tools.parent import load_parent

        par = load_parent(parent).fields.field_kernel
    libs = {} if quick else build_designs(threads)
    rows = []

    def emit(row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    ours = cases(device, fk)
    theirs = cases(device, par) if par is not None else [None] * len(ours)
    for (name, spec, call), other in zip(ours, theirs):
        want, launched = _launched(fk, spec, call)
        turns = {"library": []}
        if other is not None:
            got, par_launched = _launched(par, spec, other[2])
            assert torch.equal(got, want), f"{name}: the parent disagrees"
            turns["parent"] = []
            for order in (("library", "parent"), ("parent", "library")):
                for who in order:
                    turns[who].append(_ms(call if who == "library" else other[2], reps))
        else:
            turns["library"].append(_ms(call, reps))
        emit({"case": name, "build": "library", "launches": launched, **_attrs(cuda_lib.load()),
              "ms": sum(turns["library"]) / len(turns["library"]), "ms_each_turn": turns["library"],
              "device_ms": _device_ms(call, reps)})
        if other is not None:
            row = {"case": name, "build": "parent", "launches": par_launched,
                   "ms": sum(turns["parent"]) / 2, "ms_each_turn": turns["parent"],
                   "device_ms": _device_ms(other[2], reps)}
            if name.startswith("cumprod Fr"):
                row["launch_device_ms"] = launch_device_ms(other[2], "field_scan_kernel")
            emit(row)
        for t, path in libs.items():
            for size in sizes:
                with _design(path, size) as lib:
                    got, k = _launched(fk, spec, call)
                    assert torch.equal(got, want), f"{name}: the design {t} threads {size} disagrees"
                    emit({"case": name, "build": {"threads": t, **dict(zip(_SIZE_NAMES, size))}, "launches": k,
                          **_attrs(lib), "ms": _ms(call, reps), "device_ms": _device_ms(call, reps)})
        del want
        torch.cuda.empty_cache()
    ours = size_cases(device, fk)
    theirs = size_cases(device, par) if par is not None else [None] * len(ours)
    for (name, spec, call), other in zip(ours, theirs):
        want, launched = _launched(fk, spec, call)
        row = {"case": name, "launches": launched}
        if other is not None:
            got, row["parent_launches"] = _launched(par, spec, other[2])
            assert torch.equal(got, want), f"{name}: the parent disagrees"
            t = {"library": [], "parent": []}
            for order in (("library", "parent"), ("parent", "library")):
                for who in order:
                    t[who].append(_ms(call if who == "library" else other[2], reps))
            row.update(ms=sum(t["library"]) / 2, parent_ms=sum(t["parent"]) / 2,
                       parent_device_ms=_device_ms(other[2], reps))
        else:
            row["ms"] = _ms(call, reps)
        row["device_ms"] = _device_ms(call, reps)
        emit(row)
        for t, path in libs.items():
            for size in sizes:
                with _design(path, size):
                    got, k = _launched(fk, spec, call)
                    assert torch.equal(got, want), f"{name}: the design {t} threads {size} disagrees"
                    emit({"case": name, "build": {"threads": t, **dict(zip(_SIZE_NAMES, size))}, "launches": k,
                          "device_ms": _device_ms(call, reps)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", default=None, help="another checkout (a git archive unpacked) to time beside")
    ap.add_argument("--quick", action="store_true", help="the library and the parent only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_tiles: no CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    time_designs(args.reps, parent=args.parent, quick=args.quick)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
