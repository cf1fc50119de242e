"""The device's idle share of the traced window, in %: 1 - (union of the
intervals in which an operation ran on the device) / (the window's length),
from torch.profiler (../trace.py)."""


def read(ctx):
    t = ctx.trace
    if not t or not t["busy_s"] or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
