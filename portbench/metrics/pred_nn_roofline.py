"""The MLP head's share of its roofline: the least time of a step's head
(``counts/pred_nn.py``: layer 1 factorised over the step's distinct input
rows, layers 2 and 3 on the pairs a step that the program's
``PredictingLayer.pairs`` counter counted, the backward at twice the
forward, at the dtype's peak) over the head's device time a step that
``pred_nn_ms_per_step.train`` reads, in percent.  Nothing where the program
has no such span or counter."""

from portbench.counts import kernels as kc
from portbench.counts import pred_nn as cp

PEAKS = {"bfloat16": kc.PEAK_BF16_FLOPS, "float32": kc.PEAK_F32_FLOPS}


def read(ctx):
    pred = ctx.get("pred") if ctx.get("kind") == "train" else None
    if not pred or not pred["spans_per_step"] or not pred["pairs_per_step"]:
        return None
    spent = (pred["fwd_ms_per_step"] + pred["bwd_ms_per_step"]) / 1e3
    if spent <= 0:
        return None
    least = cp.step_bound_s(ctx["head_rows"], pred["pairs_per_step"], ctx["out"], ctx["elem"],
                            PEAKS[ctx["dtype"]])
    return 100.0 * least / spent
