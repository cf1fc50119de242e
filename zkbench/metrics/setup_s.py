"""setup_s (host clock): seconds from the process's start to the first timed request."""


def read(ctx):
    return ctx.setup_s
