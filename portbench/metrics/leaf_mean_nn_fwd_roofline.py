"""The leaf forward kernel's share of its roofline: the least time of the
step's leaf calls (``counts/kernels.py:leaf_fwd``) over their device time,
in percent."""

from portbench.counts import kernels as kc

PATTERN = "leaf_fwd_kernel"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["leaf_calls"]:
        return None
    spent = ctx["trace"].kernel_s(PATTERN)
    if spent <= 0:
        return None
    least = sum(kc.bound_s(*kc.leaf_fwd(k, p, ctx["feat_dim"], ctx["hidden"], ctx["elem"]))
                for k, p in ctx["leaf_calls"]) * ctx["steps"]
    return 100.0 * least / spent
