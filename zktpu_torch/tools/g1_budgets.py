"""Time the add and mixed add at the MSM's shapes, at several register budgets.

    python -m zktpu_torch.tools.g1_budgets [--reps 20] [--budgets 1 3 4] [--sass]

Shapes (one MSM at 2^20 points, c = 16, a batch of 16 windows):
  proj_madd (16, 2^16) rows: msm_affine's phase-1 mixed add (contiguous);
  proj_add  (16, 2^16 - 1) rows: the first step of msm_affine's block-total
            scan, two overlapping slices of one (16, 2^16, 12) plane;
  proj_add  (16, 2^20 - 1) rows: the first step of msm_proj's doubling scan,
            slices of one (16, 2^20, 12) plane.
The operands are random canonical Fq elements made on the card (the kernels
run the same instructions for any values).  A budget is the minimum number
of 128-thread blocks per SM that csrc/g1.cu's launch bound asks ptxas to fit
(ZK_ADD_MIN_BLOCKS, 3 in the port's library).  For each budget the tool
builds its own copy of g1.cu with -DZK_ADD_MIN_BLOCKS=<budget> (one nvcc per
budget, in parallel, into build/zktpu_torch/), launches it through the
port's wrappers and prints one JSON line per kernel and shape: registers and
local bytes (spills) from cudaFuncGetAttributes, ms per call with CUDA
events (wrapper included) and the share of the integer bound.  --sass also
counts the SASS instructions of the port's library (cuobjdump): one Fq
product in mont_mul_kernel<12> (with its loads and store), the chained
kernel's loop, and the add and mixed add.

Run as a file with PYTHONPATH=<another checkout> it times that tree's
library as built (its g1.cu has no budget to set) and counts its SASS.

--horner times the one-launch Horner combine instead, built once per lane
count (-DZK_HORNER_LANES=1 and 4; the library uses 4) at the paths' shapes:
c = 16, K = 1, W = 16 (an MSM at 2^20) and c = 13, K = 8, W = 20 (the PLONK
prover's commit_many at 2^14 gates).  Each row gives ms per call and the
latency of one double, ms over (W - 1) c (the adds included).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import subprocess
from collections import Counter

import torch

from zktpu_torch import cuda_lib
from zktpu_torch.curves import g1_kernel

# The card's integer rate for the bound: 32-bit multiply-adds, 64 per clock
# per SM on compute capability 9.0 x 132 SMs x 1.98 GHz (NVIDIA H100 SXM);
# a 32 x 32 -> 64-bit word product is two, a 12-limb CIOS product 2 x 300.
IMAD_PER_S = 132 * 64 * 1.98e9
FQ_PRODUCT_IMADS = 2 * (2 * 12 * 12 + 12)
SHAPES = (
    ("proj_madd", 1 << 16, False, "msm_affine phase-1 mixed add"),
    ("proj_add", 1 << 16, True, "msm_affine block-total scan, first step"),
    ("proj_add", 1 << 20, True, "msm_proj doubling scan, first step"),
)
PRODUCTS = {"proj_add": 12, "proj_madd": 11}
BUDGET_MACRO = "ZK_ADD_MIN_BLOCKS"
LANES_MACRO = "ZK_HORNER_LANES"
HORNER_SHAPES = ((16, 1, 16), (13, 8, 20))  # (c, K, W)


def _random_fq(shape, device, gen):
    """Canonical Fq limbs: a top limb below 2^28 keeps the value < 2^380 < p."""
    t = torch.randint(-(1 << 31), 1 << 31, tuple(shape) + (12,), dtype=torch.int64, device=device, generator=gen)
    t[..., 11] &= (1 << 28) - 1
    return t.to(torch.int32)


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


def _operands(width, strided, device, gen):
    B = 16
    if strided:  # P1 = plane[:, :-1], P2 = plane[:, 1:]
        planes = [_random_fq((B, width), device, gen) for _ in range(3)]
        return tuple(t[:, :-1] for t in planes), tuple(t[:, 1:] for t in planes), B * (width - 1)
    P1 = tuple(_random_fq((B, width), device, gen) for _ in range(3))
    A2 = tuple(_random_fq((B, width), device, gen) for _ in range(2))
    return P1, A2, B * width


def _has_budget() -> bool:
    with open(os.path.join(cuda_lib.CSRC_DIR, "g1.cu")) as f:
        return BUDGET_MACRO in f.read()


def build_budgets(budgets, macro: str = BUDGET_MACRO, source: str = "g1.cu") -> dict:
    """{value: path} of `source` (csrc/) built once per value of `macro`, all nvcc at once."""
    src = os.path.join(cuda_lib.CSRC_DIR, source)
    h = hashlib.sha256(" ".join(cuda_lib.NVCC_FLAGS).encode())
    for name in cuda_lib.HEADERS + (source,):
        with open(os.path.join(cuda_lib.CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(source)[0]
    paths = {b: os.path.join(cuda_lib.BUILD_DIR, f"lib{stem}_{macro}{b}-{h.hexdigest()[:16]}.so") for b in budgets}
    nvcc = cuda_lib.find_nvcc()
    procs = {b: subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, f"-D{macro}={b}", "-shared", "-o", path, src],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for b, path in paths.items() if not os.path.exists(path)}
    for b, p in procs.items():
        err = p.communicate()[1]
        if p.returncode != 0:
            raise cuda_lib.KernelBuildError(f"nvcc at {macro}={b} failed ({p.returncode}):\n{err}")
    return paths


@contextlib.contextmanager
def _library(path, names=("zk_proj_add", "zk_proj_madd", "zk_proj_double", "zk_g1_kernel_attrs", "zk_horner_combine")):
    """The wrappers launch the kernels of the library at `path` (None: the
    port's own), entry points `names`, inside this block."""
    if path is None:
        yield
        return
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    saved = cuda_lib.load
    cuda_lib.load = lambda: lib
    try:
        yield
    finally:
        cuda_lib.load = saved


def time_budgets(reps: int = 20, budgets=(1, 3, 4), device=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    libs = build_budgets(budgets) if _has_budget() else {None: None}
    attrs = hasattr(cuda_lib.load(), "zk_g1_kernel_attrs")
    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    rows = []
    for name, width, strided, what in SHAPES:
        a1, a2, n = _operands(width, strided, device, gen)
        fn = getattr(g1_kernel, name)
        bound_ms = PRODUCTS[name] * n * FQ_PRODUCT_IMADS / IMAD_PER_S * 1e3
        for budget, path in libs.items():
            row = {"kernel": name, "rows": n, "shape": f"(16, {n // 16})", "what": what, "min_blocks": budget}
            with _library(path):
                if attrs:
                    row.update(g1_kernel.kernel_attrs(name))
                row["ms"] = _ms(lambda: fn(a1, a2), reps)
            row["bound_ms"] = bound_ms
            row["bound_share"] = bound_ms / row["ms"]
            rows.append(row)
            print(json.dumps(row), flush=True)
        del a1, a2
        torch.cuda.empty_cache()
    return rows


def time_horner(reps: int = 20, lanes=(1, 4), device=None) -> list[dict]:
    """The Horner combine at the paths' shapes, once per lane count."""
    from zktpu_torch.curves import g1
    from zktpu_torch.curves.host_curve import G1Affine

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    libs = build_budgets(lanes, LANES_MACRO)
    G = G1Affine.generator()
    rows = []
    for c, K, W in HORNER_SHAPES:
        pts = [G.mul(3 + 7 * i) for i in range(W * K)]
        parts = tuple(t.reshape(W, K, 12) for t in g1.host_points_to_device(pts, device))
        ref = None
        for n_lanes, path in libs.items():
            with _library(path):
                got = g1_kernel.horner_combine(parts, c)
                ref = got if ref is None else ref
                assert all(torch.equal(a, b) for a, b in zip(got, ref)), "the lane counts disagree"
                row = {"kernel": "horner_combine", "c": c, "K": K, "W": W, "lanes": n_lanes,
                       **g1_kernel.kernel_attrs("horner_combine"), "ms": _ms(lambda: g1_kernel.horner_combine(parts, c), reps)}
            row["us_per_double"] = 1e3 * row["ms"] / ((W - 1) * c)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


# Kernel functions to count, by their mangled names.
_KERNELS = (
    ("mont_mul_kernel<12>", r"15mont_mul_kernelILi12E"),
    ("mont_mul_chain_kernel<12>", r"21mont_mul_chain_kernelILi12E"),
    ("proj_add_kernel", r"15proj_add_kernel"),
    ("proj_madd_kernel", r"16proj_madd_kernel"),
)


def sass_counts(library: str | None = None, kernels=_KERNELS) -> dict:
    """Per kernel function ((label, mangled-name pattern) pairs): IMAD
    (multiplies and multiply-adds, not IMAD.MOV moves), IMAD.MOV, IADD3 and
    all instructions of its SASS, and "by_op": the count of each opcode
    (its name up to the first dot)."""
    library = library or cuda_lib.build()
    tool = os.path.join(os.path.dirname(cuda_lib.find_nvcc() or "/usr/local/cuda/bin/nvcc"), "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True).stdout
    counts, by_op, current = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((label for label, pat in kernels if re.search(pat, m.group(1))), None)
            if current:
                counts[current] = Counter()
                by_op[current] = Counter()
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current and ins:
            op = ins.group(1)
            by_op[current][op.split(".")[0]] += 1
            c = counts[current]
            c["total"] += 1
            if op.startswith("IMAD.MOV"):
                c["IMAD.MOV"] += 1
            elif op.startswith("IMAD"):
                c["IMAD"] += 1
            elif op.startswith("IADD3"):
                c["IADD3"] += 1
    return {k: {**v, "by_op": dict(by_op[k])} for k, v in counts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--budgets", type=int, nargs="+", default=[1, 3, 4],
                    help="minimum 128-thread blocks per SM for each build of g1.cu")
    ap.add_argument("--sass", action="store_true", help="also count SASS instructions with cuobjdump")
    ap.add_argument("--horner", action="store_true", help="time the Horner combine at 1 and 4 lanes per point instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("g1_budgets: no CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    if args.horner:
        time_horner(args.reps)
        return 0
    time_budgets(args.reps, tuple(args.budgets))
    if args.sass:
        print(json.dumps({"sass": sass_counts()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
