"""What the profiling tools share: the card's name and power limit, and the
summary of one run traced by torch.profiler."""
from __future__ import annotations

import subprocess
import time

import torch

_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def trace_summary(run, rows: int = 15) -> tuple[dict, str]:
    """run() under torch.profiler: (launch calls, device kernels, wall and
    device seconds, idle share, the eight longest kernels' device
    milliseconds and every kernel's (device ms, launches) by name; the
    profiler's table by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device work only: the kernels and copies, which take no CPU time (an
    # aten op's row repeats the device time of the kernels it launched)
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.self_cpu_time_total == 0]
    dev_s = sum(e.self_device_time_total for e in device) / 1e6
    summary = {
        "launch_calls": sum(e.count for e in events if e.key in _LAUNCH_CALLS),
        "device_kernels": sum(e.count for e in device if not e.key.startswith(("Memcpy", "Memset"))),
        "wall_s": wall,
        "device_s": dev_s,
        "idle_share": max(0.0, 1 - dev_s / wall),
        "by_kernel_ms": {e.key[:60]: e.self_device_time_total / 1e3
                         for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]},
        "by_name_ms": {},  # every kernel's device ms and launches, by its name without template arguments
    }
    for e in device:
        name = e.key.removeprefix("void ").split("<")[0].split("(")[0]
        ms, count = summary["by_name_ms"].get(name, (0.0, 0))
        summary["by_name_ms"][name] = (ms + e.self_device_time_total / 1e3, count + e.count)
    return summary, events.table(sort_by="self_device_time_total", row_limit=rows)


def launch_device_ms(fn, name: str, reps: int = 3) -> list[float]:
    """Device milliseconds of each launch, in order, of the kernels whose
    name holds `name` in one call of fn: the mean over `reps` calls, each
    traced on its own by torch.profiler (after one untraced call).  A trace
    that saw another number of launches than most is taken again (the
    profiler has dropped device events on the H100 machine), at most 3 reps
    times in all; [] if no trace saw one (the caller reports "not
    measured")."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3 * reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name),
                        key=lambda e: e.time_range.start)
        if events:
            runs.append([e.time_range.elapsed_us() / 1e3 for e in events])
        counts = Counter(len(r) for r in runs).most_common(1)
        if counts and counts[0][1] >= reps:
            break
    if not runs:
        return []
    k = Counter(len(r) for r in runs).most_common(1)[0][0]
    runs = [r for r in runs if len(r) == k]
    return [sum(r[i] for r in runs) / len(runs) for i in range(k)]
