"""Device operations a cell update of the LSTM reducer: the operations a
training step that ``lstm_ms_per_step.train`` times, over the cell updates
a step that the program's ``MaskedLSTMReducer.slot_steps`` counter counted
in the same eager steps.  A fused slot would cut it.  Nothing where the
program has no such span or counter."""


def read(ctx):
    lstm = ctx.get("lstm") if ctx.get("kind") == "train" else None
    if not lstm or not lstm["spans_per_step"] or not lstm["slot_steps_per_step"]:
        return None
    return (lstm["fwd_ops_per_step"] + lstm["bwd_ops_per_step"]) / lstm["slot_steps_per_step"]
