"""Time the tensor-core chained products (kernels 5m, 5f) at several register budgets.

    python -m zktpu_torch.tools.mma_budgets [--reps 20] [--budgets 1 3 4 5] [--log-n 16 20]

For each budget, the minimum number of 128-thread blocks per SM that
csrc/mont_mma.cu's launch bound asks ptxas to fit (-DZK_MMA_MIN_BLOCKS; the
port's library sets none), the tool builds its own copy of mont_mma.cu (one
nvcc per budget, in parallel, into build/zktpu_torch/) and launches it
through the port's wrapper, beside the library's own build ("min_blocks":
null).  For Fq and
Fr, each body (mxu, f32) and each N = 2^log_n random elements it checks the
output against the base plain chain once, then prints one JSON line:
registers and local bytes (spills) from cudaFuncGetAttributes, ms per
launch of CHAIN = 12 products (CUDA events over back-to-back launches),
products per second and the share of the body's bound
(prof_mulkernels.chain_bound).  The port's base body (csrc/mont_mul.cu) is
timed beside them on the same inputs.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from zktpu_torch.fields.host import FQ, FR
from zktpu_torch.fields.mont_kernel import mont_mma_attrs, mont_mul_chain, mont_mul_chain_plain
from zktpu_torch.tools.g1_budgets import _library, _ms, build_budgets
from zktpu_torch.tools.prof_mulkernels import chain_bound, rand_elems

BUDGET_MACRO = "ZK_MMA_MIN_BLOCKS"
CHAIN = 12


def time_budgets(reps: int = 20, budgets=(1, 3, 4, 5), log_ns=(16, 20), device=None) -> list[dict]:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    libs = build_budgets(budgets, BUDGET_MACRO, "mont_mma.cu")
    rows = []
    for spec in (FQ, FR):
        for log_n in log_ns:
            n = 1 << log_n
            a, b = rand_elems(spec, n, device, 0), rand_elems(spec, n, device, 1)
            want = mont_mul_chain_plain(spec, a[:4096], b[:4096], CHAIN)
            cases = [("base", None)] + [(v, budget) for v in ("mxu", "f32") for budget in (None, *libs)]
            for variant, budget in cases:
                row = {"field": spec.name, "variant": variant, "n": n, "chain": CHAIN, "min_blocks": budget}
                with _library(libs.get(budget)):
                    got = mont_mul_chain(spec, a[:4096], b[:4096], CHAIN, variant)
                    assert torch.equal(got, want), f"{variant} at {budget} blocks differs from the base plain chain"
                    if variant != "base":
                        row.update(mont_mma_attrs(spec, variant))
                    row["ms"] = _ms(lambda: mont_mul_chain(spec, a, b, CHAIN, variant), reps)
                bound = chain_bound(spec, variant, n, CHAIN)
                row.update(mmul_per_s=n * CHAIN / row["ms"] / 1e3, bound_ms=bound["bound_ms"],
                           bound_pipe=bound["bound_pipe"], bound_share=bound["bound_ms"] / row["ms"])
                rows.append(row)
                print(json.dumps(row), flush=True)
            del a, b
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--budgets", type=int, nargs="+", default=[1, 3, 4, 5],
                    help="minimum 128-thread blocks per SM for each build of mont_mma.cu")
    ap.add_argument("--log-n", type=int, nargs="+", default=[16, 20], help="log2 of the element counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mma_budgets: no CUDA device", file=sys.stderr)
        return 2
    time_budgets(args.reps, args.budgets, args.log_n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
