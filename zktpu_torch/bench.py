"""KZG commit (Pippenger MSM) throughput of zktpu_torch on one CUDA GPU.

    python -m zktpu_torch.bench [--log-n 20] [--iters 3] [--window C] [--profile]

The port's counterpart of the repo's bench.py, on the same inputs: N = 2^n
scalars from np.random.default_rng(12345), and the SRS-like points tau^i G
for tau = 0x1F3A5, made by the windowed fixed-base multiply and put in affine
form by one batch inversion (Srs.g1_affine).  It times msm_proj on (Xa, Ya,
Z = 1) and msm_affine on (Xa, Ya) with the same scalars at pick_window(N),
checks that both give the same point, and prints one JSON line under its own
metric name, torch_kzg_commit_msm_points_per_s_2e{n} (msm_proj, the path
bench.py measures), with the card's name.  It reads no earlier record (the
BENCH_r*.json files hold TPU figures) and writes no file.  Without a CUDA
device it raises.  --profile also traces one call of each MSM with
torch.profiler and prints its device time by kernel to stderr.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .curves import g1, msm
from .fields.fp import field, norm_device
from .fields.host import FQ, FR
from .kzg.srs import Srs

TAU = 0x1F3A5
SEED = 12345


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(log_n: int, device=None) -> dict:
    """The benchmark's scalars and affine points, with the seconds each step took."""
    device = norm_device(device)
    n = 1 << log_n
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    scalars = [int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(n)]
    t1 = time.perf_counter()
    sc = g1.scalars_to_u32(scalars, device)
    _sync(device)
    t2 = time.perf_counter()
    srs = Srs.new_from_secret(TAU, n - 3, device)  # n points tau^i G
    Xa, Ya = srs.g1_affine()
    _sync(device)
    t3 = time.perf_counter()
    return {
        "scalars": scalars, "sc": sc, "Xa": Xa, "Ya": Ya,
        "seconds": {"scalars_host": t1 - t0, "scalars_u32": t2 - t1, "points": t3 - t2},
    }


def _best(fn, iters: int, device: torch.device):
    """(result of a first call, best seconds over `iters` timed calls)."""
    out = fn()
    _sync(device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return out, best


def run(log_n: int = 20, iters: int = 3, window: int | None = None, device=None, inputs: dict | None = None) -> dict:
    """Time msm_proj and msm_affine on the benchmark's inputs; the two must agree."""
    device = norm_device(device)
    inp = inputs or make_inputs(log_n, device)
    sc, Xa, Ya = inp["sc"], inp["Xa"], inp["Ya"]
    n = sc.shape[0]
    c = window or msm.pick_window(n)
    Z1 = field(FQ, device).one.expand_as(Xa).contiguous()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    proj, proj_s = _best(lambda: msm.msm_proj(sc, Xa, Ya, Z1, c=c), iters, device)
    aff, aff_s = _best(lambda: msm.msm_affine(sc, Xa, Ya, c=c), iters, device)
    got = g1.proj_to_affine_host(tuple(torch.stack([a, b]) for a, b in zip(proj, aff)))
    if got[0] != got[1]:
        raise AssertionError(f"msm_affine != msm_proj at 2^{log_n}: {got[1]} vs {got[0]}")
    return {
        "n": n, "window": c, "result": got[0],
        "msm_proj_s": proj_s, "msm_affine_s": aff_s,
        "msm_proj_points_per_s": n / proj_s, "msm_affine_points_per_s": n / aff_s,
        "setup_s": inp["seconds"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    }


def profile(log_n: int = 20, window: int | None = None, device=None, inputs: dict | None = None, rows: int = 12) -> str:
    """One traced call of each MSM: device time by kernel, and device time
    against wall time (the idle share), as a printable table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    device = norm_device(device)
    inp = inputs or make_inputs(log_n, device)
    sc, Xa, Ya = inp["sc"], inp["Xa"], inp["Ya"]
    c = window or msm.pick_window(sc.shape[0])
    Z1 = field(FQ, device).one.expand_as(Xa).contiguous()
    out = []
    for name, fn in (("msm_proj", lambda: msm.msm_proj(sc, Xa, Ya, Z1, c=c)),
                     ("msm_affine", lambda: msm.msm_affine(sc, Xa, Ya, c=c))):
        fn()
        _sync(device)
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(device)
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        # device work only: the kernels and copies, which take no CPU time (an
        # aten op's row repeats the device time of the kernels it launched)
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == DeviceType.CUDA and e.self_cpu_time_total == 0)
        out.append(f"# profile {name} 2^{log_n} c={c}: wall {wall * 1e3:.1f} ms, device {dev_us / 1e3:.1f} ms "
                   f"(idle {100 * max(0.0, 1 - dev_us / 1e6 / wall):.1f}%), "
                   f"{sum(e.count for e in events if e.key == 'cudaLaunchKernel')} kernel launches")
        out.append(events.table(sort_by="self_device_time_total", row_limit=rows))
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="zktpu_torch KZG commit (MSM) throughput on one CUDA GPU")
    ap.add_argument("--log-n", type=int, default=20, help="log2 number of MSM points")
    ap.add_argument("--iters", type=int, default=3, help="timed runs of each MSM (the best counts)")
    ap.add_argument("--window", type=int, default=None, help="window bits (default: pick_window(N))")
    ap.add_argument("--profile", action="store_true", help="also trace one call of each MSM (stderr)")
    args = ap.parse_args(argv)
    device = norm_device(None)  # the current CUDA device; raises without one
    inputs = make_inputs(args.log_n, device)
    r = run(args.log_n, args.iters, args.window, device, inputs)
    if args.profile:
        print(profile(args.log_n, args.window, device, inputs), file=sys.stderr)
    print(
        f"# msm 2^{args.log_n} c={r['window']} on {torch.cuda.get_device_name(device)}: "
        f"setup {json.dumps({k: round(v, 3) for k, v in r['setup_s'].items()})} s, "
        f"msm_proj best {r['msm_proj_s'] * 1e3:.1f} ms, msm_affine best {r['msm_affine_s'] * 1e3:.1f} ms, "
        f"peak memory {r['max_memory_allocated']} bytes",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": f"torch_kzg_commit_msm_points_per_s_2e{args.log_n}",
        "value": r["msm_proj_points_per_s"],
        "unit": "points/s",
        "msm_affine_points_per_s": r["msm_affine_points_per_s"],
        "device": torch.cuda.get_device_name(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
