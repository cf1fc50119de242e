"""Trace one PLONK prove with torch.profiler: kernel launches, device time
by kernel, and device time against wall time (the idle share).

    python -m zktpu_torch.tools.prof_prove [--log-n 14] [--rows 15] [--repeat N]

The circuit is synthetic_mul_chain(log_n) (seed 1) with an SRS from a fixed
secret, on the current CUDA device; one untraced prove warms the caches
first.  Prints one JSON line (launch calls, device kernels, wall and device
seconds, idle share, the longest kernels' device ms) and the profiler's
table by device time to stderr.
--repeat N then times N untraced proves and verifies (host clock around
work that ends in a synchronise) and prints them with each prove's rounds.
Run as a file with PYTHONPATH=<another checkout> it traces that checkout's
prover.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

SEED = 20261016
SRS_SECRET = 0x5EED5EED


def trace_prove(circuit, srs, seed: int = SEED, rows: int = 15) -> tuple[dict, str]:
    """One prove under the profiler: (summary, table by device time)."""
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.tools.trace import trace_summary
    from zktpu_torch.transcript.chacha import StdRng

    return trace_summary(lambda: generate_proof(circuit, srs, StdRng.from_seed_u64(seed)), rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=14)
    ap.add_argument("--rows", type=int, default=15)
    ap.add_argument("--repeat", type=int, default=0, help="then time this many untraced proves and verifies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_prove: no CUDA device")
    from zktpu_torch.kzg import Srs
    from zktpu_torch.plonk.prover import generate_proof
    from zktpu_torch.plonk.synthetic import synthetic_mul_chain
    from zktpu_torch.plonk.verifier import verify
    from zktpu_torch.transcript.chacha import StdRng

    device = torch.device("cuda", 0)
    circuit = synthetic_mul_chain(args.log_n, seed=1, device=device)
    srs = Srs.new_from_secret(SRS_SECRET, circuit.size, device=device)
    generate_proof(circuit, srs, StdRng.from_seed_u64(SEED))
    summary, table = trace_prove(circuit, srs, rows=args.rows)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "log_n": args.log_n, **summary}), flush=True)
    print(table, file=sys.stderr)
    for _ in range(args.repeat):
        timings = {}
        t0 = time.perf_counter()
        proof = generate_proof(circuit, srs, StdRng.from_seed_u64(SEED), timings=timings)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        verify(circuit, srs, proof)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rounds = {k: v for k, v in timings.items() if "." in k}
        print(json.dumps({"prove_s": t1 - t0, "verify_s": t2 - t1, "rounds": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
