"""The commitments' share of their roofline, in %: the least time of their MSMs
(../yardstick.py: Pippenger's fewest bucket additions for N points and K
vectors, as mixed additions of 32-bit word products, over the card's integer
multiply-add peak) over their measured device time (CUDA events around each
outermost KzgScheme.commit_coeffs / commit_many call, ../spans.py)."""


def read(ctx):
    spans = [s for s in ctx.spans if s["device_s"]]
    if not spans or ctx.card is None:
        return None
    least = sum(ctx.yardstick.msm_muladds(s["n"], s["k"]) for s in spans) / ctx.card["muladds_per_s"]
    return 100.0 * least / sum(s["device_s"] for s in spans)
