"""Milliseconds of a prove outside its commitments: the traced window's host
seconds less those of the outermost KzgScheme.commit_coeffs / commit_many
calls (../spans.py), over the proofs finished (the PLONK rounds: host
scalars, NTTs, scans, linear combinations)."""


def read(ctx):
    if not ctx.requests or not ctx.spans:
        return None
    return 1e3 * (ctx.window_s - sum(s["host_s"] for s in ctx.spans)) / ctx.requests
