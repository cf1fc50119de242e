"""The control of a cell's check: the reference in the program's place, its
commitments made from scalars cut to their low 128 bits (an MSM over
half-width scalars, the lower precision that would tempt a faster program).

    python3 zkbench/control.py --workload <name> --seeds <n,n,...> [--requests K]

For each seed it makes the cell's inputs as a run does (the program is not
run), answers the K requests that a window of the cell would finish with the
control, and judges them by the cell's own check.  One JSON line a seed: the
numbers compared with their limits, and whether the check calls the control
correct (it must not).  On a CUDA device when there is one; the benchmark's
runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or os.curdir) == HERE:
    sys.path[0] = ROOT
CONTROL_BITS = 128


def control(root: str, workload: str, seed: int, requests: int, scalar_bits: int, device) -> dict:
    from zkbench import manifest

    cell = manifest.Cell(root, manifest.load(root), workload)
    run = cell.driver.setup(cell.config, cell.traffic, seed, device)
    answers = [{} for _ in range(requests)]  # finished requests; the check's sample is taken from them
    picks = run.picks(answers)
    for i, ans in run.reference(picks, scalar_bits=scalar_bits).items():
        answers[i] = ans
    compared, checked = run.check(answers)
    ok = checked > 0 and all(v <= lim for v, lim in compared.values())
    return {"workload": workload, "seed": seed, "scalar_bits": scalar_bits, "requests": requests,
            "checked": checked, "check": {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()},
            "correct": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--requests", type=int, default=6, help="requests a window finishes")
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control(ROOT, args.workload, seed, args.requests, CONTROL_BITS, device)
        out["seconds"] = time.perf_counter() - t0
        out["device"] = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
