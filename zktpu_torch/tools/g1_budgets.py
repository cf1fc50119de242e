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

(The Horner combine has its own tool, tools/horner_lanes.py.)
"""
from __future__ import annotations

import argparse
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
    return cuda_lib.build_variants(source, {b: (f"-D{macro}={b}",) for b in budgets})


def _library(path):
    """The wrappers launch the kernels of the library at `path` (None: the
    port's own) inside this block."""
    return cuda_lib.launching(None if path is None else cuda_lib.load_variant(path))


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
    all instructions of its SASS, "by_op": the count of each opcode (its
    name up to the first dot) and "by_full_op": of each opcode with its
    modifiers (IMAD.WIDE.U32, IADD3.X, ...)."""
    library = library or cuda_lib.build()
    tool = os.path.join(os.path.dirname(cuda_lib.find_nvcc() or "/usr/local/cuda/bin/nvcc"), "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True).stdout
    counts, by_op, by_full, current = {}, {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((label for label, pat in kernels if re.search(pat, m.group(1))), None)
            if current:
                counts[current] = Counter()
                by_op[current] = Counter()
                by_full[current] = Counter()
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current and ins:
            op = ins.group(1)
            by_op[current][op.split(".")[0]] += 1
            by_full[current][op] += 1
            c = counts[current]
            c["total"] += 1
            if op.startswith("IMAD.MOV"):
                c["IMAD.MOV"] += 1
            elif op.startswith("IMAD"):
                c["IMAD"] += 1
            elif op.startswith("IADD3"):
                c["IADD3"] += 1
    return {k: {**v, "by_op": dict(by_op[k]), "by_full_op": dict(by_full[k])} for k, v in counts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--budgets", type=int, nargs="+", default=[1, 3, 4],
                    help="minimum 128-thread blocks per SM for each build of g1.cu")
    ap.add_argument("--sass", action="store_true", help="also count SASS instructions with cuobjdump")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("g1_budgets: no CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; library {cuda_lib.build()}", flush=True)
    time_budgets(args.reps, tuple(args.budgets))
    if args.sass:
        print(json.dumps({"sass": sass_counts()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
