"""Device milliseconds a training step of the LSTM reducer's operations,
forward and backward: those that the program's ``gnn.lstm.reduce`` spans
launched and those that the backward of their ops launched, over the
traced run's eager steps (``drivers/device_epochs_lstm.py``,
``harness/trace_ops.py``).  Nothing where the program has no such span."""


def read(ctx):
    lstm = ctx.get("lstm") if ctx.get("kind") == "train" else None
    if not lstm or not lstm["spans_per_step"]:
        return None
    return lstm["fwd_ms_per_step"] + lstm["bwd_ms_per_step"]
