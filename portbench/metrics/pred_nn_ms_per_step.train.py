"""Device milliseconds a training step of the MLP head's operations, forward
and backward: those that the program's ``gnn.pred.score`` spans launched
and those that the backward of their ops launched, over the traced run's
eager steps (``drivers/device_epochs_pred_nn.py``,
``harness/trace_ops.py``).  Nothing where the program has no such span."""


def read(ctx):
    pred = ctx.get("pred") if ctx.get("kind") == "train" else None
    if not pred or not pred["spans_per_step"]:
        return None
    return pred["fwd_ms_per_step"] + pred["bwd_ms_per_step"]
