"""peak_mem_gb (read by the benchmark from the host): torch.cuda.max_memory_allocated()
over set-up and window, in 10^9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
