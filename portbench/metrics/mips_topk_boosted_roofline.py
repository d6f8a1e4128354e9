"""``mips_topk_boosted``'s share of its roofline over the traced requests:
the least time of each request's two passes (``counts/serve_ranked.py:
boost_passes``) over the device time of every kernel they launch (the
scoring pass of each, the merge of ``mips_boost``'s partial lists, the
combine of ``mips_lse``'s partial sums), in percent."""

from portbench.counts import kernels as kc

KERNELS = ("topk_kernel", "merge_kernel", "lse_combine_kernel")


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("boost_calls"):
        return None
    spent = ctx["trace"].kernel_s(lambda name: any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    return 100.0 * sum(kc.bound_s(*call) for call in ctx["boost_calls"]) / spent
