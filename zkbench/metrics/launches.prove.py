"""Kernel launch calls of the host per proof, counted in the profiler's trace of
the window (cudaLaunchKernel, cuLaunchKernel and their Ex forms, ../trace.py)."""


def read(ctx):
    if not ctx.trace or not ctx.trace["launches"] or not ctx.requests:
        return None
    return ctx.trace["launches"] / ctx.requests
