"""The dense pool's false-negative mask kernel's share of its roofline: the
least time of the step's calls (``counts/kernels.py:pool_mask``, one per
training edge type) over their device time, in percent."""

from portbench.counts import kernels as kc

PATTERN = "pool_mask"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["pool_calls"]:
        return None
    spent = ctx["trace"].kernel_s(PATTERN)
    if spent <= 0:
        return None
    least = sum(kc.bound_s(*kc.pool_mask(*call)) for call in ctx["pool_calls"]) * ctx["steps"]
    return 100.0 * least / spent
