"""The host time of the field kernels' wrappers, step by step, on the card,
beside another checkout's wrappers.

    python -m zktpu_torch.tools.wrapper_split [--parent build/parent] [--calls 1000]

Rows: ``mont_mul`` Fr at the coset division's (2^17, 8) x (2^17, 8),
``mont_mul`` Fq at (2^16 + 3, 12) x (2^16 + 3, 12), and the Fr add
(``field_addsub``) at (2^17, 8) + (2^17, 8).  Each step is one statement of
the wrapper on the path a CUDA tensor takes, run alone `calls` times, each
call timed by time.perf_counter_ns (the clock's own cost, timed the same
way, subtracted): the shape rule, the field constants, the operands'
layout, the operand checks, the output's allocation, the library handle,
the stream, the launch (the C entry point: ctypes, cudaSetDevice, the
kernel's enqueue; synchronised every 64 calls, outside the timed calls) and
the counter.  "whole" is the wrapper as a caller calls it, timed the same
way; "events_ms" its mean over back-to-back calls on CUDA events (as
chip_smoke.py's ms); "kernel_ms" the kernel alone (torch.profiler).  The
steps of this checkout and of the parent (tools/parent.py: its own
library, wrappers and helpers) are timed in turns: this, parent, parent,
this.  One JSON line a row, then the card and its power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from zktpu_torch.tools.trace import launch_device_ms, smi  # noqa: E402

SYNC_EVERY = 64


def _clock_ns(calls: int) -> float:
    """The mean cost of one perf_counter_ns pair around nothing."""
    clock = time.perf_counter_ns
    total = 0
    for _ in range(calls):
        t0 = clock()
        total += clock() - t0
    return total / calls


def time_us(fn, calls: int, clock_ns: float, sync: bool = False) -> float:
    """Mean host microseconds of fn() over `calls` calls, each timed alone."""
    clock = time.perf_counter_ns
    fn()
    torch.cuda.synchronize()
    total = 0
    for i in range(calls):
        t0 = clock()
        fn()
        total += clock() - t0
        if sync and i % SYNC_EVERY == SYNC_EVERY - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return max(total / calls - clock_ns, 0.0) / 1e3


def _events_ms(fn, reps: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _shape_step(pkg, a, b):
    """The wrapper's shape rule: the port's own on plain tuples where the
    checkout has it, else torch.broadcast_shapes."""
    rule = getattr(pkg.cuda_lib, "broadcast_shapes", None)
    if rule is None:
        return lambda: tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))

    def step():
        sa, sb = tuple(a.shape[:-1]), tuple(b.shape[:-1])
        return sa if sa == sb else rule(sa, sb)
    return step


def _consts_steps(pkg, spec) -> dict:
    """field_consts, and (for a checkout whose field_consts hands back the
    limbs' array) the address read from it."""
    cl = pkg.cuda_lib
    p, _ = cl.field_consts(spec)
    steps = {"consts": lambda: cl.field_consts(spec)}
    if not isinstance(p, int):
        steps["address"] = lambda: p.ctypes.data
    return steps


def mont_mul_steps(pkg, spec, a, b) -> tuple:
    """({step: fn}, the whole call, the kernel's name) of pkg's mont_mul on
    CUDA operands a, b (equal shapes)."""
    cl, mk = pkg.cuda_lib, pkg.fields.mont_kernel
    limbs = spec.num_digits // 2
    shape = _shape_step(pkg, a, b)()
    n = a.numel() // limbs
    out = torch.empty(tuple(shape) + (limbs,), dtype=torch.int32, device=a.device)
    lib = cl.load()
    p, pinv = cl.field_consts(spec)
    p = p if isinstance(p, int) else p.ctypes.data
    stream = cl.stream_of(out)
    steps = {"shape": _shape_step(pkg, a, b), **_consts_steps(pkg, spec),
             "operands": lambda: (mk._broadcast_operand(a, shape), mk._broadcast_operand(b, shape)),
             "checks": lambda: cl.check_cuda_operands("mont_mul", (a, b), limbs),
             "empty": lambda: torch.empty(tuple(shape) + (limbs,), dtype=torch.int32, device=a.device),
             "library": cl.load,
             "stream": lambda: cl.stream_of(out),
             "launch": lambda: lib.zk_mont_mul(a.device.index, limbs, p, pinv, a.data_ptr(), n, b.data_ptr(), n,
                                               out.data_ptr(), n, stream),
             "counter": lambda: mk.mont_mul.launches.__setitem__(spec.name, mk.mont_mul.launches[spec.name] + 1)}
    return steps, (lambda: mk.mont_mul(spec, a, b)), "mont_mul_kernel"


def add_steps(pkg, f, a, b) -> tuple:
    """({step: fn}, the whole call, the kernel's name) of pkg's field add on
    CUDA operands a, b (equal shapes)."""
    cl, fk = pkg.cuda_lib, pkg.fields.field_kernel
    L = f.num_limbs
    shape = _shape_step(pkg, a, b)()
    n = a.numel() // L
    out = torch.empty(tuple(shape) + (L,), dtype=torch.int32, device=a.device)
    lib = cl.load()
    p, pinv = cl.field_consts(f.spec)
    p = p if isinstance(p, int) else p.ctypes.data
    stream = cl.stream_of(out)
    steps = {"checks": lambda: cl.check_cuda_operands("field_add", (a, b), L, contiguous=False),
             "library": cl.load,
             "shape": _shape_step(pkg, a, b), **_consts_steps(pkg, f.spec),
             "operands": lambda: (fk._aligned(*fk._broadcast_operand(a, shape)),
                                  fk._aligned(*fk._broadcast_operand(b, shape))),
             "empty": lambda: torch.empty(tuple(shape) + (L,), dtype=torch.int32, device=a.device),
             "stream": lambda: cl.stream_of(out),
             "launch": lambda: lib.zk_field_addsub(a.device.index, L, p, pinv, 0, a.data_ptr(), n, b.data_ptr(), n,
                                                   out.data_ptr(), n, stream),
             "counter": lambda: fk.launches["field_addsub"].__setitem__(f.spec.name,
                                                                        fk.launches["field_addsub"][f.spec.name] + 1)}
    return steps, (lambda: fk.add(f, a, b)), "field_addsub_kernel"


def _rows(f, n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=f.device)
    gen.manual_seed(seed)
    L, p = f.num_limbs, f.spec.modulus
    t = torch.randint(-(1 << 31), 1 << 31, (n, L), dtype=torch.int64, device=f.device, generator=gen)
    t[:, L - 1] &= (1 << ((p.bit_length() - 1) % 32)) - 1
    return t.to(torch.int32)


def split(pkgs: dict, calls: int = 1000) -> list[dict]:
    """For each row, each checkout's steps and whole call (host us), events
    ms and kernel ms, in turns; the results' words compared."""
    from zktpu_torch.fields.host import FQ, FR

    clock_ns = _clock_ns(calls)
    device = torch.device("cuda", 0)
    rows = []
    for name, spec, n, make in (("mont_mul Fr (2^17, 8) x (2^17, 8)", FR, 1 << 17, mont_mul_steps),
                                ("mont_mul Fq (2^16 + 3, 12) x (2^16 + 3, 12)", FQ, (1 << 16) + 3, mont_mul_steps),
                                ("field_addsub Fr add (2^17, 8) + (2^17, 8)", FR, 1 << 17, add_steps)):
        fr = {who: pkg.fields.fp.field(spec, device) for who, pkg in pkgs.items()}
        a, b = _rows(fr["this"], n, 1), _rows(fr["this"], n, 2)
        built = {}
        for who, pkg in pkgs.items():
            built[who] = make(pkg, spec, a, b) if make is mont_mul_steps else make(pkg, fr[who], a, b)
        outs = [whole() for _, whole, _ in built.values()]
        assert all(torch.equal(o, outs[0]) for o in outs), f"{name}: the checkouts' words differ"
        order = ["this", "parent", "parent", "this"] if "parent" in pkgs else ["this"]
        res = {who: {"steps_us": {}, "whole_us": [], "events_ms": []} for who in pkgs}
        for who in order:
            steps, whole, _ = built[who]
            for step, fn in steps.items():
                res[who]["steps_us"].setdefault(step, []).append(time_us(fn, calls, clock_ns, sync=step == "launch"))
            res[who]["whole_us"].append(time_us(whole, calls, clock_ns, sync=True))
            res[who]["events_ms"].append(_events_ms(whole))
        for who in pkgs:
            steps, whole, kernel = built[who]
            each = launch_device_ms(whole, kernel, reps=3)
            r = res[who]
            r["steps_us"] = {k: statistics.fmean(v) for k, v in r["steps_us"].items()}
            r["sum_of_steps_us"] = sum(r["steps_us"].values())
            r["kernel_ms"] = each[0] if each else None
        rows.append({"row": name, **res})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="another checkout (a git archive unpacked) to time beside this one")
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wrapper_split: no CUDA device", file=sys.stderr)
        return 2
    import zktpu_torch
    import zktpu_torch.fields.fp  # noqa: F401  (the submodules the steps name)
    import zktpu_torch.fields.field_kernel  # noqa: F401

    pkgs = {"this": zktpu_torch}
    if args.parent:
        from zktpu_torch.tools.parent import load_parent

        pkgs["parent"] = load_parent(args.parent)
    for pkg in pkgs.values():
        pkg.cuda_lib.build()
    split(pkgs, args.calls)
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
