"""The leaf backward's share of its roofline (both of its kernels): the
least time of the step's leaf calls (``counts/kernels.py:leaf_bwd``) over
their device time, in percent."""

from portbench.counts import kernels as kc

PATTERN = "leaf_bwd"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["leaf_calls"]:
        return None
    spent = ctx["trace"].kernel_s(PATTERN)
    if spent <= 0:
        return None
    least = sum(kc.bound_s(*kc.leaf_bwd(k, p, ctx["feat_dim"], ctx["hidden"], ctx["elem"]))
                for k, p in ctx["leaf_calls"]) * ctx["steps"]
    return 100.0 * least / spent
