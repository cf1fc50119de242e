"""commit_open_s (host clock): the window's seconds over the commit-and-open requests it finished."""


def read(ctx):
    return ctx.window_s / ctx.requests if ctx.requests else None
