"""Time the MSM's Horner combine (horner_combine_kernel) in other designs.

    python -m zktpu_torch.tools.horner_lanes [--reps 10] [--chain 2000] [--parent DIR]

csrc/g1.cuh fixes the lanes that share one Montgomery product (ZK_HORNER_P)
and the products a warp runs at once (ZK_HORNER_G); the library's design is
(HORNER_P, HORNER_G) as built, which zk_horner_design reports.  This tool
builds its own copy of g1.cu for each design in DESIGNS (one nvcc per design,
all at once, into build/zktpu_torch/) and, with --parent, loads another
checkout's package (a `git archive` of an earlier commit unpacked under DIR;
tools/parent.py) to time its horner_combine as it stands.  At each shape of SHAPES,
(c, K, W) with K points of W windows of c bits, it makes the parts from
multiples of G on the host, holds every build's words against the
library's (and the library's against the plain loop at the path's shape,
the first), and times each build with CUDA events over --reps calls, in
turns (library, designs, parent, then back): one JSON line per build and
shape with registers, local bytes (spills), ms per call and microseconds per
dependent product step, (W - 1)(2c + 2) of them, beside the card's name and
power limit.  Then, for each design, the latency of one product: one warp
runs a chain of --chain dependent products (zk_horner_mul_chain, each
gathered whole before the next, as the combine uses them), checked against
the plain chain; the line gives microseconds per product and, at each shape,
the depth figure (W - 1)(2c + 2) x that latency with the share of the
combine's time it explains (the rest is the sums, the gathers and the loads).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import random
import subprocess

import numpy as np
import torch

from zktpu_torch import cuda_lib
from zktpu_torch.curves import g1, g1_kernel
from zktpu_torch.curves.host_curve import G1Affine
from zktpu_torch.fields.mont_kernel import mont_mul_chain_plain
from zktpu_torch.tools.g1_budgets import _ms
from zktpu_torch.tools.trace import smi

# (lanes a product, products at once); the library's default is (3, 6)
DESIGNS = ((1, 6), (2, 6), (3, 6), (4, 6), (6, 4))
# (c, K, W): the PLONK and Nova commits at 2^14 (c = 13, W = 20; K = 1 for
# one commit, 3 and 8 for commit_many), and the MSM bench's at 2^20
SHAPES = ((13, 1, 20), (13, 3, 20), (13, 8, 20), (16, 1, 16))


def steps(c: int, W: int) -> int:
    """Dependent product steps of the chain: two a double, two an add."""
    return (W - 1) * (2 * c + 2)


def build_designs(designs=DESIGNS) -> dict:
    """{design: path} of g1.cu built once per design, all nvcc at once."""
    return cuda_lib.build_variants("g1.cu", {d: (f"-DZK_HORNER_P={d[0]}", f"-DZK_HORNER_G={d[1]}") for d in designs})


def design_of(lib) -> tuple[int, int]:
    out = (ctypes.c_int * 2)()
    cuda_lib.check(lib.zk_horner_design(out), "horner design")
    return out[0], out[1]


def run_combine(lib, parts, c: int):
    """horner_combine through `lib`'s kernel (the port's wrapper, its
    library swapped for the call)."""
    with cuda_lib.launching(lib):
        return g1_kernel.horner_combine(parts, c)


def attrs_of(lib) -> dict:
    out = (ctypes.c_int * 3)()
    cuda_lib.check(lib.zk_g1_kernel_attrs(3, out), "horner attributes")
    return {"registers": out[0], "local_bytes": out[1]}


def mul_chain(lib, a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """x = a, then x = x b R^-1 `chain` times in one warp (a, b: (1, 12) canonical Fq rows)."""
    out = torch.empty_like(a)
    p, pinv = cuda_lib.field_consts(g1_kernel.FQ)
    ptrs = np.array([a.data_ptr(), b.data_ptr(), out.data_ptr()], dtype=np.int64)
    cuda_lib.check(lib.zk_horner_mul_chain(a.device.index, p, pinv, ptrs.ctypes.data, chain,
                                           cuda_lib.stream_of(out)), "horner_mul_chain")
    return out


def parts_for(c: int, K: int, W: int, device, seed: int = 20261018):
    """(W, K, 12) x 3 parts: random multiples of G, one of them the identity."""
    rng = random.Random(seed + 1000 * c + 10 * K + W)
    G = G1Affine.generator()
    pts = [G.mul(rng.randrange(1, 1 << 30)) for _ in range(W * K)]
    pts[K % (W * K)] = G1Affine.identity()
    return tuple(t.reshape(W, K, 12) for t in g1.host_points_to_device(pts, device))


def time_designs(reps: int = 10, chain: int = 2000, designs=DESIGNS, parent: str | None = None,
                 shapes=SHAPES, device=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    libs = {"library": cuda_lib.load(), **{d: cuda_lib.load_variant(p) for d, p in build_designs(designs).items()}}
    combine = {name: functools.partial(run_combine, lib) for name, lib in libs.items()}
    if parent:
        from zktpu_torch.tools.parent import load_parent

        par = load_parent(parent)
        libs["parent"] = par.cuda_lib.load()
        combine["parent"] = par.curves.g1_kernel.horner_combine
    card = smi()
    lib_design = design_of(libs["library"])
    rows = []
    for c, K, W in shapes:
        parts = parts_for(c, K, W, device)
        want = combine["library"](parts, c)
        if (c, K, W) == shapes[0]:
            plain = g1_kernel.horner_combine_plain(parts, c)
            assert all(torch.equal(x, y) for x, y in zip(want, plain)), "the library differs from the plain loop"
        for name in libs:
            got = combine[name](parts, c)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), f"Horner build {name} differs from the library"
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):  # in turns, then back
            for name in order:
                times[name].append(_ms(lambda: combine[name](parts, c), reps))
        for name, lib in libs.items():
            ms = sum(times[name]) / len(times[name])
            row = {"build": name if isinstance(name, str) else dict(zip(("P", "G"), name)), "c": c, "K": K, "W": W,
                   **attrs_of(lib), "ms": ms, "ms_each_turn": times[name], "steps": steps(c, W),
                   "us_per_step": 1e3 * ms / steps(c, W), "card": card}
            if name == "library":
                row["design"] = dict(zip(("P", "G"), lib_design))
            rows.append(row)
            print(json.dumps(row), flush=True)
    # one product's latency, per design
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    a, b = (torch.randint(0, 1 << 31, (1, 12), dtype=torch.int32, device=device, generator=gen) for _ in range(2))
    a[..., 11] &= (1 << 28) - 1  # < 2^380 < p
    b[..., 11] &= (1 << 28) - 1
    want = mont_mul_chain_plain(g1_kernel.FQ, a, b, 64)
    for name, lib in libs.items():
        if name == "parent":
            continue
        assert torch.equal(mul_chain(lib, a, b, 64), want), f"the product chain of {name} differs from the plain"
        us = 1e3 * _ms(lambda: mul_chain(lib, a, b, chain), 3) / chain
        depth = {}
        for r in rows:
            if r["build"] == (name if isinstance(name, str) else dict(zip(("P", "G"), name))):
                d_ms = r["steps"] * us * 1e-3
                depth[f"{r['c']},{r['K']},{r['W']}"] = {"depth_ms": d_ms, "share": d_ms / r["ms"]}
        row = {"build": name if isinstance(name, str) else dict(zip(("P", "G"), name)), "chain": chain,
               "us_per_product": us, "depth": depth, "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


# The components of the chain, each timed in cycles (clock64) as a chain of
# `reps` dependent runs in one warp: one lazy sum (add_red, sub_red), 12 a
# (fq_mul12_lazy), a gather of a value spread over a group, one product
# without and with its gather, a whole double and a whole add.
PROBE_SRC = r"""
#include <cuda_runtime.h>
#include "g1.cuh"

__device__ __forceinline__ long long probe_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

__global__ void __launch_bounds__(32, 1)
horner_probe_kernel(const uint32_t* in, uint32_t* out, long long* cycles, uint32_t reps, FqConsts f) {
  constexpr int L = FQ_LIMBS;
  const uint32_t lane = threadIdx.x;
  const HornerLane h = horner_lane(lane, f);
  HornerArgs args;
  for (int i = 0; i < 3; ++i) { args.parts[i] = in + i * L; args.out[i] = out + i * L; }
  args.W = args.K = 1;
  args.c = 0;
  uint32_t x[L], y[L], z[L], o[HORNER_N + 1], ad[HORNER_N];
  load_row(x, in);
  load_row(y, in + L);
  load_row(z, in + 2 * L);
  long long t[9];
  t[0] = probe_clock();
  for (uint32_t i = 0; i < reps; ++i) add_red<L>(x, x, y, f.p2);
  t[1] = probe_clock();
  for (uint32_t i = 0; i < reps; ++i) sub_red<L>(x, x, y, f.p2);
  t[2] = probe_clock();
  for (uint32_t i = 0; i < reps; ++i) fq_mul12_lazy(x, x, f);
  t[3] = probe_clock();
  for (uint32_t i = 0; i < reps; ++i) {
    horner_digit(o, x, h.d);
    o[HORNER_N] = 0;
    horner_gather(x, o, h.g);
  }
  t[4] = probe_clock();
  horner_digit(ad, x, h.d);
  for (uint32_t i = 0; i < reps; ++i) {
    horner_mul(o, ad, y, h);
    for (int k = 0; k < HORNER_N; ++k) ad[k] = o[k];
  }
  for (int k = 0; k < HORNER_N; ++k) x[k] ^= ad[k];
  t[5] = probe_clock();
  for (uint32_t i = 0; i < reps; ++i) {
    horner_product(o, x, y, h);
    horner_gather(x, o, h.g);
  }
  t[6] = probe_clock();
  for (uint32_t i = 0; i < reps; ++i) horner_double(x, y, z, h, f);
  t[7] = probe_clock();
  for (uint32_t i = 0; i < reps; ++i) horner_add(x, y, z, args, 0, 0, h, f);
  t[8] = probe_clock();
  if (lane == 0) {
    store_row(out, x);
    store_row(out + L, y);
    store_row(out + 2 * L, z);
    for (int i = 0; i < 8; ++i) cycles[i] = t[i + 1] - t[i];
  }
}

extern "C" int zk_horner_probe(const uint32_t* p, uint32_t pinv, const uint32_t* in, uint32_t* out,
                               long long* cycles, uint32_t reps) {
  horner_probe_kernel<<<1, 32>>>(in, out, cycles, reps, make_consts<FQ_LIMBS>(p, pinv));
  return (int)cudaGetLastError();
}
"""
PROBE_PARTS = ("add_red", "sub_red", "mul12", "gather", "product", "product_gather", "double", "add")


def probe(designs=DESIGNS, reps: int = 200, device=None) -> list[dict]:
    """Cycles of each component (PROBE_PARTS) for each design, built from
    PROBE_SRC with g1.cuh (all nvcc at once)."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_lib.BUILD_DIR, "horner_probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    nvcc = cuda_lib.find_nvcc()
    paths = {d: os.path.join(cuda_lib.BUILD_DIR, "libhorner_probe_p{}_g{}.so".format(*d)) for d in designs}
    procs = {d: subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, f"-DZK_HORNER_P={d[0]}", f"-DZK_HORNER_G={d[1]}",
                                  "-I", cuda_lib.CSRC_DIR, "-shared", "-o", path, src],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for d, path in paths.items()}
    for d, p in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            raise cuda_lib.KernelBuildError(f"nvcc for the probe at {d} failed ({p.returncode}):\n{err}")
    pts = parts_for(13, 1, 2, device)
    inp = torch.cat([t[0] for t in pts]).contiguous()
    out = torch.empty_like(inp)
    cyc = torch.zeros(8, dtype=torch.int64, device=device)
    p, pinv = cuda_lib.field_consts(g1_kernel.FQ)
    rows = []
    for d, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.zk_horner_probe.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_uint32]
        for _ in range(2):  # the first run warms the instruction cache
            cuda_lib.check(lib.zk_horner_probe(p, pinv, inp.data_ptr(), out.data_ptr(),
                                               cyc.data_ptr(), reps), "horner probe")
            torch.cuda.synchronize()
        row = {"build": dict(zip(("P", "G"), d)), "reps": reps,
               "cycles_each": {k: int(v) / reps for k, v in zip(PROBE_PARTS, cyc.tolist())}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--chain", type=int, default=2000)
    ap.add_argument("--parent", default=None, help="another checkout whose g1.cu to time beside")
    ap.add_argument("--probe", action="store_true", help="only the cycles of the chain's components")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("horner_lanes: no CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; {smi()}", flush=True)
    if args.probe:
        probe()
        return 0
    print(f"library {cuda_lib.build()}", flush=True)
    time_designs(args.reps, args.chain, parent=args.parent)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
