"""Reduce a torch.profiler trace of the window to what the metrics read.

Device time is the union of the intervals in which an operation (a kernel,
a copy or a set) ran on the device, so overlapping work counts once.
Launches are the host's kernel launch calls.  The breakdown lists the device
operations that took most time, by the profiler's names, and the longest idle
stretches of the device by the innermost host operation running in them.
"""
from __future__ import annotations

from collections import defaultdict

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
TOP = 10


def union_length(intervals) -> tuple[float, list]:
    """(total length, the merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def innermost(cpu: list, points: list) -> list[str]:
    """For each time point (ascending), the name of the innermost host
    operation running at it ("idle host" where none is): a sweep over the
    operations in order of start, keeping the nested ones on a stack."""
    cpu = sorted(cpu, key=lambda c: (c[0], -c[1]))
    out, stack, j = [], [], 0
    for m in points:
        while j < len(cpu) and cpu[j][0] <= m:
            while stack and stack[-1][1] <= cpu[j][0]:
                stack.pop()
            stack.append(cpu[j])
            j += 1
        while stack and stack[-1][1] <= m:
            stack.pop()
        out.append(stack[-1][2] if stack else "idle host")
    return out


def reduce(events, window_us: tuple[float, float], thread=None) -> dict:
    """events: (name, start us, end us, on_device, thread) tuples; window_us:
    the traced window; thread: the host thread whose operations name the
    idle gaps (all: None).  -> busy_s, launches, device_ops, idle_gaps."""
    lo, hi = window_us
    dev, cpu, launches = [], [], 0
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e, on_device, th in events:
        if on_device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                dev.append((s, e))
                by_name[name] += e - s
        else:
            if name in LAUNCH_CALLS:
                launches += 1
            if thread is None or th == thread:
                cpu.append((s, e, name))
    busy, merged = union_length(dev)
    gaps, prev = [], lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle: dict[str, float] = defaultdict(float)
    for (s, e), name in zip(gaps, innermost(cpu, [(s + e) / 2 for s, e in gaps])):
        idle[name] += e - s
    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"busy_s": busy / 1e6, "launches": launches, "device_ops": top(by_name), "idle_gaps": top(idle)}


def profiler_events(prof, prefix: str = "zkbench.") -> list:
    """(name, start us, end us, on_device, thread) of every event of a
    torch.profiler run; a record_function range's mirror on the device's
    timeline (a user annotation, no work of the device; the benchmark's
    ranges are named with `prefix`) is left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        if on_device and (getattr(e, "is_user_annotation", False) or e.name.startswith(prefix)):
            continue
        tr = e.time_range
        out.append((e.name, float(tr.start), float(tr.end), on_device, e.thread))
    return out
