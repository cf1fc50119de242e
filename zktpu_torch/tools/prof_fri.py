"""Time and trace the FRI prover on the card: prove and verify seconds, the
split of a prove between the NTT, the hashing, the fold and the host, and
kernel launches and the idle share of one traced prove.

    python -m zktpu_torch.tools.prof_fri [--log-n 20] [--blowup 2] [--queries 32] [--repeat 3] [--rows 15] [--sass]

The polynomial has 2^log_n / blowup Goldilocks coefficients from numpy's
default_rng(SEED) (a 2^log_n domain, log_n layers), made on the current
CUDA device; one untraced prove warms the caches (the domains' tables)
first.  Prints JSON lines:

- "repeat": prove_s and verify_s of each of --repeat untraced proves and
  host verifies (host clock around work that ends in a synchronise), and
  their medians;
- "split": one more prove with the card synchronized around each piece
  (fri/prover.py's timings): the coset NTTs, from_mont fused ("ntt"), the
  trees ("hash"), the root reads and challenges ("root"), the folds
  ("fold") and the query phase ("query"), summed over the layers, and the
  rest of the prove's wall time ("host");
- "trace": one prove under torch.profiler: launch calls, device kernels,
  wall and device seconds, idle share; the table by device time goes to
  stderr;
- with --sass, "sass": the SASS instructions of the field hash's two
  kernels (one hash each: straight-line code) and of the Goldilocks NTT
  kernel, by opcode (cuobjdump, tools/g1_budgets.py's counter).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

SEED = 20261017
QUERIES = 32


def fri_poly(log_coeffs: int, seed: int = SEED, device=None):
    """2^log_coeffs Goldilocks coefficients from default_rng(seed), as a Poly
    on `device` (encoded to Montgomery form there) and as numpy uint64."""
    from zktpu_torch.fields.fp import field
    from zktpu_torch.fields.host import GOLDILOCKS
    from zktpu_torch.poly.poly import Poly

    vals = np.random.default_rng(seed).integers(0, GOLDILOCKS.modulus, size=1 << log_coeffs, dtype=np.uint64)
    df = field(GOLDILOCKS, device)
    raw = torch.from_numpy(vals.view(np.int32).reshape(-1, 2).copy()).to(df.device)
    return Poly(GOLDILOCKS, df.to_mont(raw)), vals


def trace_prove(poly, blowup: int, queries: int, rows: int = 15) -> tuple[dict, str]:
    """One FRI prove under the profiler: (summary, table by device time)."""
    from zktpu_torch.fri.prover import generate_proof
    from zktpu_torch.tools.trace import trace_summary

    return trace_summary(lambda: generate_proof(poly, blowup, queries), rows)


def timed_runs(poly, blowup: int, queries: int, repeat: int) -> dict:
    """prove_s and verify_s of `repeat` untraced proves and host verifies, with medians."""
    from zktpu_torch.fri.prover import generate_proof
    from zktpu_torch.fri.verifier import verify

    prove_s, verify_s = [], []
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = generate_proof(poly, blowup, queries)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        verify(proof)
        verify_s.append(time.perf_counter() - t1)
        prove_s.append(t1 - t0)
    return {"prove_s": prove_s, "verify_s": verify_s, "prove_median_s": statistics.median(prove_s),
            "verify_median_s": statistics.median(verify_s)}


def split(poly, blowup: int, queries: int) -> dict:
    """One prove with the card synchronized around each piece: seconds by piece."""
    from zktpu_torch.fri.prover import generate_proof

    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_proof(poly, blowup, queries, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {**timings, "host": wall - sum(timings.values()), "wall_s": wall}


# The FRI path's kernel functions, by their mangled names.
SASS_KERNELS = (
    ("sha256_field_kernel<0>", r"19sha256_field_kernelILi0E"),
    ("sha256_field_kernel<1>", r"19sha256_field_kernelILi1E"),
    ("ntt_gl_kernel", r"13ntt_gl_kernel"),
)


# Opcodes that are not 32-bit integer work of the per-thread pipes: memory,
# control, special registers, the uniform datapath, and no-ops.
_NOT_INT_OPS = ("NOP", "LDG", "STG", "LDC", "LDS", "STS", "S2R", "S2UR", "EXIT", "BRA", "BSSY", "BSYNC", "BAR")


def hash_int_ops(library: str | None = None) -> dict:
    """The 32-bit integer instructions of one hash in each mode: the SASS of
    sha256_field_kernel<0> (single) and <1> (pairs), which is straight-line
    code for one thread, less memory, control, special-register and uniform
    instructions (cuobjdump).  Also the shifts and logic ops, which have no
    form on the multiply-add pipe."""
    from zktpu_torch.tools.g1_budgets import sass_counts

    counts = sass_counts(library, kernels=SASS_KERNELS[:2])
    out = {}
    for mode, label in (("single", "sha256_field_kernel<0>"), ("pairs", "sha256_field_kernel<1>")):
        by_op = counts[label]["by_op"]
        out[mode] = sum(n for op, n in by_op.items() if op not in _NOT_INT_OPS and not op.startswith("U"))
        out[mode + "_shf_lop3"] = by_op.get("SHF", 0) + by_op.get("LOP3", 0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20, help="log2 of the domain")
    ap.add_argument("--blowup", type=int, default=2)
    ap.add_argument("--queries", type=int, default=QUERIES)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--rows", type=int, default=15)
    ap.add_argument("--sass", action="store_true", help="also count the SASS of the hash and NTT kernels")
    args = ap.parse_args(argv)
    from zktpu_torch.fields.fp import norm_device
    from zktpu_torch.fri.prover import generate_proof

    device = norm_device(None)  # the current CUDA device; raises without one
    log_coeffs = args.log_n - (args.blowup.bit_length() - 1)
    poly, _ = fri_poly(log_coeffs, device=device)
    generate_proof(poly, args.blowup, args.queries)  # warm: the domains' tables
    head = {"device": torch.cuda.get_device_name(0), "log_n": args.log_n, "blowup": args.blowup,
            "queries": args.queries}
    print(json.dumps({**head, "repeat": timed_runs(poly, args.blowup, args.queries, args.repeat)}), flush=True)
    print(json.dumps({**head, "split": split(poly, args.blowup, args.queries)}), flush=True)
    summary, table = trace_prove(poly, args.blowup, args.queries, args.rows)
    print(json.dumps({**head, "trace": summary}), flush=True)
    print(table, file=sys.stderr)
    if args.sass:
        from zktpu_torch.tools.g1_budgets import sass_counts

        print(json.dumps({"sass": sass_counts(kernels=SASS_KERNELS), "hash_int_ops": hash_int_ops()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
