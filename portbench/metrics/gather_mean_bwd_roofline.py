"""The gather-mean backward kernel's share of its roofline on the dedup'd
block forward: the least time of one step's neighbour means
(``counts/kernels.py:gather_mean_bwd``, their valid slots and distinct
source rows counted on the reference's first step) over the kernel's
device time a step, in percent."""

from portbench.counts import kernels as kc

PATTERN = "gather_mean_bwd"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["gather_calls"] or not ctx["steps"]:
        return None
    spent = ctx["trace"].kernel_s(PATTERN)
    if spent <= 0:
        return None
    least = sum(kc.bound_s(*kc.gather_mean_bwd(b, k, n, ctx["hidden"], valid, named, ctx["elem"]))
                for b, k, n, valid, named in ctx["gather_calls"])
    return 100.0 * least * ctx["steps"] / spent
