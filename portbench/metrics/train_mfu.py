"""The training step's model FLOPs a second over the chip's peak for the
configuration's dtype, in percent (``counts/model.py``; the traced window's
host seconds)."""

from portbench.counts import kernels as kc

PEAKS = {"bfloat16": kc.PEAK_BF16_FLOPS, "float32": kc.PEAK_F32_FLOPS}


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    tr = ctx["trace"]
    return 100.0 * ctx["step_flops"] * ctx["steps"] / tr.window_s / PEAKS[ctx["dtype"]]
