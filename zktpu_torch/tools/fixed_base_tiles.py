"""Time the fixed-base window multiply at other block sizes and register
budgets, beside another checkout's design.

    python -m zktpu_torch.tools.fixed_base_tiles [--reps 5] [--log-n 20] [--parent DIR] [--srs-turns 5]

csrc/g1.cuh fixes the threads of a block of fixed_base_kernel
(ZK_FB_THREADS) and csrc/g1.cu the minimum blocks a SM its launch bound asks
ptxas to fit (ZK_FB_MIN_BLOCKS); zk_fixed_base_design reports the library's.
This tool builds its own copy of g1.cu for each design in DESIGNS (one nvcc
each, all at once, into build/zktpu_torch/) and, with --parent, loads
another checkout's package (a `git archive` of another commit unpacked
under DIR; tools/parent.py) to time its fixed_base_mul as it stands.  At
each shape (2^log_n scalars, an SRS of that size, and the PLONK SRS's
2^14 + 3) it makes random scalars with the edge scalars 0, 1, r - 1 and
2^256 - 1 first and a zero digit in every third, holds the library's words
against the plain loop at 2^14 + 3 (and on the first 2^12 scalars of the
other shape), every build's and the parent's against the library's, and
times each with CUDA events (the wrapper included) in turns (library,
designs, parent, then back), and kernel only (torch.profiler).  One JSON
line per build and shape: registers, local bytes (spills), shared bytes a
block, ms, kernel-only ms, the bound (32 n adds of 11 products over the
integer rate: Z1·Z2 is a select, since every row but O is affine) and its
share, the 12-product figure of a complete add beside it (the rows before
the redesign), and the zero digits among these scalars, beside the card's
name and power limit.  Last, one line of Srs.new_from_secret at 2^log_n
points, this package's and the parent's in turns, each call as a caller
sees it and split where the multiply ends (srs_times).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from zktpu_torch import cuda_lib
from zktpu_torch.curves import g1, g1_kernel
from zktpu_torch.curves.host_curve import G1Affine
from zktpu_torch.fields.fp import ints_to_limbs
from zktpu_torch.fields.host import FR
from zktpu_torch.tools.g1_budgets import FQ_PRODUCT_IMADS, IMAD_PER_S, _ms
from zktpu_torch.tools.trace import launch_device_ms, smi

# (threads a block, minimum blocks a SM); the library's is (192, 2).  Shared
# memory a block at window 8: 48 KB of staged rows and 176 bytes a thread
# (accumulator and scalar).
DESIGNS = ((128, 3), (128, 2), (256, 1), (256, 2))
WINDOW = 8


def build_designs(designs=DESIGNS) -> dict:
    """{design: path} of g1.cu built once per design, all nvcc at once."""
    return cuda_lib.build_variants("g1.cu", {d: (f"-DZK_FB_THREADS={d[0]}", f"-DZK_FB_MIN_BLOCKS={d[1]}")
                                             for d in designs})


def run(lib, tables, sc):
    """fixed_base_mul through `lib`'s kernel (the port's wrapper, its library swapped for the call)."""
    with cuda_lib.launching(lib):
        return g1_kernel.fixed_base_mul(tables, sc, WINDOW)


def attrs_of(lib) -> dict:
    out = (ctypes.c_int * 3)()
    cuda_lib.check(lib.zk_g1_kernel_attrs(4, out), "fixed_base attributes")
    design = (ctypes.c_int * 2)()
    cuda_lib.check(lib.zk_fixed_base_design(design), "fixed_base design")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2], "threads": design[0],
            "min_blocks": design[1]}


def scalars(n: int, seed: int, device) -> torch.Tensor:
    """(n, 8) scalar limbs: 0, 1, r - 1, 2^256 - 1, then random ones, every
    third with one digit (byte) of 0."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    k = min(n, 4)
    words[:k] = ints_to_limbs([0, 1, FR.modulus - 1, (1 << 256) - 1][:k], 8).view(np.uint32)
    digits = words.view(np.uint8).reshape(n, 32)
    rows = np.arange(4, n, 3)
    digits[rows, rng.integers(0, 32, size=rows.size)] = 0
    return torch.from_numpy(words.view(np.int32)).to(device)


def zero_digits(sc: torch.Tensor) -> int:
    """Digits (bytes) of 0 among the scalars: the adds of O."""
    return int((sc.cpu().numpy().view(np.uint8) == 0).sum())


def bound_ms(n: int, products: int = 11) -> float:
    """The bound: 32 n adds of `products` Fq products over the integer rate.
    The function needs 11 an add (every table row but O is affine, so Z1 Z2
    is Z1 or 0); 12, a complete add's count, gives the figure that rows
    before the redesign were held to."""
    return 32 * n * products * FQ_PRODUCT_IMADS / IMAD_PER_S * 1e3


def time_designs(reps: int = 5, log_n: int = 20, designs=DESIGNS, parent: str | None = None,
                 device=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    builds = {"library": cuda_lib.load(), **{d: cuda_lib.load_variant(p) for d, p in build_designs(designs).items()}}
    par = None
    if parent:
        from zktpu_torch.tools.parent import load_parent

        par = load_parent(parent)
    card = smi()
    G = G1Affine.generator()
    tables = g1.fixed_base_tables(G, WINDOW, device)
    rows = []
    for n in ((1 << 14) + 3, 1 << log_n):
        sc = scalars(n, 20261018 + n, device)
        want = run(builds["library"], tables, sc)
        check = min(n, (1 << 14) + 3)
        plain = g1_kernel.fixed_base_mul_plain(tables, sc[:check], WINDOW)
        assert all(torch.equal(a[:check], b) for a, b in zip(want, plain)), "the library differs from the plain loop"
        calls = {name: (lambda lib=lib: run(lib, tables, sc)) for name, lib in builds.items()}
        if par is not None:
            calls["parent"] = lambda: par.curves.g1_kernel.fixed_base_mul(tables, sc, WINDOW)
        for name, call in calls.items():
            got = call()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), f"fixed-base build {name} differs from the library"
        times = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):  # in turns, then back
            for name in order:
                times[name].append(_ms(calls[name], reps))
        zeros, bound, bound12 = zero_digits(sc), bound_ms(n), bound_ms(n, 12)
        for name, call in calls.items():
            ms = sum(times[name]) / len(times[name])
            kernel_ms = sum(launch_device_ms(call, "fixed_base_kernel", reps=2)) or None
            row = {"build": name if isinstance(name, str) else dict(zip(("threads", "min_blocks"), name)), "n": n,
                   **(attrs_of(builds[name]) if name in builds else {}), "ms": ms, "ms_each_turn": times[name],
                   "kernel_ms": kernel_ms, "bound_ms": bound, "share": bound / kernel_ms if kernel_ms else None,
                   "bound_ms_12_products": bound12, "zero_digits": zeros, "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del want, plain
        torch.cuda.empty_cache()
    return rows


SRS_SECRET = 0x5EC2E7


def srs_times(pkg, n: int, device) -> dict:
    """Seconds of pkg's Srs.new_from_secret(n - 3) (n points; pkg: this
    package, or another checkout's from tools/parent.py), synced at its end
    as a caller sees it ("total"); then a second call split where its
    fixed-base multiply ends, synced there: "to_multiply" (the powers and
    the multiply on the card, from the call's start) and "after" (what the
    host does once the card is done: its G2 multiplication by the secret)."""
    import importlib

    srs = importlib.import_module(pkg.__name__ + ".kzg").Srs
    g1_mod = importlib.import_module(pkg.__name__ + ".curves.g1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srs.new_from_secret(SRS_SECRET, n - 3, device=device)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    saved, mark = g1_mod.fixed_base_mul_u32, []

    def synced(*args, **kwargs):
        out = saved(*args, **kwargs)
        torch.cuda.synchronize()
        mark.append(time.perf_counter())
        return out

    g1_mod.fixed_base_mul_u32 = synced
    try:
        t0 = time.perf_counter()
        srs.new_from_secret(SRS_SECRET, n - 3, device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        g1_mod.fixed_base_mul_u32 = saved
    return {"total": total, "to_multiply": mark[0] - t0, "after": t1 - mark[0]}


def srs_turns(parent_pkg=None, log_n: int = 20, turns: int = 3, device=None) -> dict:
    """srs_times of this package and, given, of the parent's, in turns
    (library, parent, parent, library, ...) `turns` times each after one
    warm call of each: {"library": [...], "parent": [...]}."""
    import zktpu_torch

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    pkgs = {"library": zktpu_torch, **({"parent": parent_pkg} if parent_pkg is not None else {})}
    for pkg in pkgs.values():
        srs_times(pkg, 1 << log_n, device)  # warm: the builds, the tables
    out = {k: [] for k in pkgs}
    for k in range(turns):
        for name in (list(pkgs) if k % 2 == 0 else list(pkgs)[::-1]):
            out[name].append(srs_times(pkgs[name], 1 << log_n, device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--parent", default=None, help="another checkout (a git archive unpacked) to time beside")
    ap.add_argument("--srs-turns", type=int, default=5, help="Srs.new_from_secret calls of each, in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fixed_base_tiles: no CUDA device")
    time_designs(args.reps, args.log_n, parent=args.parent)
    par = None
    if args.parent:
        from zktpu_torch.tools.parent import load_parent

        par = load_parent(args.parent)
    print(json.dumps({"srs_new_from_secret_s": srs_turns(par, args.log_n, args.srs_turns), "n": 1 << args.log_n,
                      "card": smi()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
