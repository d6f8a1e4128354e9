"""``mips_topk``'s share of its roofline over the traced requests: the
least time of each request's ranking (``counts/kernels.py:mips_topk``) over
the device time of every kernel the wrapper launches (the scoring pass and
the merge of its partial lists), in percent."""

from portbench.counts import kernels as kc

KERNELS = ("topk_kernel", "merge_kernel")


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["mips_calls"]:
        return None
    spent = ctx["trace"].kernel_s(lambda name: any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    return 100.0 * sum(kc.bound_s(*call) for call in ctx["mips_calls"]) / spent
