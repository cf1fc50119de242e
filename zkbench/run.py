"""Run one cell of the zktpu_torch benchmark once, on one CUDA device.

    python3 zkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: build or load the port's kernel library (in
build/zktpu_torch/ of the checkout), make the cell's inputs from the seed,
warm up one request of the cell's shapes (all of that is set-up), then send
requests in a closed loop, one client, for --seconds: the window closes when
the request running at that moment ends.  Then the check: the program's
state is freed and the plain reference recomputes the answers (a sample of
them, as the traffic file says) from the same seeded inputs.  The last line
of standard output is one JSON object: correct, attempted, failed, the
cell's metrics (end-to-end with --trace 0, per-layer with --trace 1, which
runs the window under torch.profiler), the device, with --trace 1 the
breakdown, and last the numbers compared with their limits, which also end
standard error.  Without a CUDA device, or with fewer than the cell's chips,
or with JAX or zktpu loaded after the window, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import os
import sys
import time

T_START = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or os.curdir) == HERE:
    sys.path[0] = ROOT  # run as a file: import zkbench as a package, and shadow no module by its files

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "zktpu")


def cache_env(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _window(cell, seconds: float, sync) -> tuple[list, int, float, float]:
    answers, failed, shown = [], 0, False
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while not answers or time.perf_counter() < deadline:
        try:
            ans = cell.request(len(answers))
            sync()
        except Exception:  # a request that fails counts as failed; the stream goes on
            if not shown:
                traceback.print_exc()
                shown = True
            ans, failed = None, failed + 1
        answers.append(ans)
    return answers, failed, t0, time.perf_counter()


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device, t_start: float):
    """One run; returns (result dict, the check's lines) or raises SystemExit."""
    import torch

    from zkbench import manifest, spans as spans_mod, trace as trace_mod, yardstick

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = manifest.Cell(root, manifest.load(root), workload)
    if cuda:
        from zktpu_torch import cuda_lib

        cuda_lib.load()
        torch.cuda.reset_peak_memory_stats()
    run = cell.driver.setup(cell.config, cell.traffic, seed, device)
    run.build()
    run.warm()
    sync()
    setup_s = time.time() - t_start

    card = yardstick.card() if cuda else None
    recorder, summary = None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        recorder = spans_mod.CommitSpans(cuda).install()
        labels = spans_mod.Labels().install()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        try:
            with profile(activities=acts) as prof:
                with record_function("zkbench.window"):
                    answers, failed, t0, t1 = _window(run, seconds, sync)
        finally:
            labels.uninstall()
            recorder.uninstall()
        events = trace_mod.profiler_events(prof)
        win = [(s, e, th) for name, s, e, dev, th in events if name == "zkbench.window" and not dev][0]
        summary = trace_mod.reduce(events, win[:2], thread=win[2])
        summary["window_s"] = (win[1] - win[0]) / 1e6
        del prof, events
    else:
        answers, failed, t0, t1 = _window(run, seconds, sync)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = banned_modules()
    if found:
        raise SystemExit(f"zkbench: the run loaded {', '.join(found)}; no result")

    ctx = SimpleNamespace(
        requests=sum(a is not None for a in answers), window_s=t1 - t0, setup_s=setup_s, peak_bytes=peak,
        spans=recorder.finish() if recorder else [], trace=summary, card=card, yardstick=yardstick,
    )
    run.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared, checked = run.check(answers)
    print(f"zkbench: set-up {setup_s:.2f} s, window {t1 - t0:.2f} s ({len(answers)} requests), "
          f"check {time.perf_counter() - t_check:.2f} s", file=sys.stderr, flush=True)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok = failed == 0 and checked > 0 and all(v <= lim for v, lim in compared.values())
    dev = {"platform": "gpu" if cuda else device.type, "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": len(answers), "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    check = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    check["answers_checked"] = {"value": checked, "limit": "at least 1"}
    check["requests_failed"] = {"value": failed, "limit": 0}
    result["check"] = check
    lines = [f"check {k} {c['value']} limit {c['limit']}" for k, c in check.items()]
    if card:
        lines.insert(0, f"card {card['name']}, {card['sms']} SMs, {card['clock_mhz']} MHz, "
                        f"power limit {card['power_limit_w']} W")
    found = banned_modules()
    if found:
        raise SystemExit(f"zkbench: the run loaded {', '.join(found)}; no result")
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the zktpu_torch benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    import torch

    from zkbench import manifest

    torch.set_num_threads(1)  # one process of few threads: the host's share of a run stays steady

    chips = manifest.Cell(ROOT, manifest.load(ROOT), args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"zkbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
