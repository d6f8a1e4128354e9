"""The LSTM cell update's kernels' share of their roofline: the least time
of the traced steps' cell updates (``counts/lstm_cell.py``: 21 H elements
a row-slot at 3.35 TB/s, for the row-slots a step that the program's
``MaskedLSTMReducer.row_slots`` counter counted in the eager steps) over
the device time of both kernels (``lstm_cell_*``) in the traced window, in
percent.  Nothing where the program has no such kernel or counter."""

from portbench.counts import lstm_cell as lc

PATTERN = "lstm_cell"


def read(ctx):
    lstm = ctx.get("lstm") if ctx.get("kind") == "train" else None
    if not lstm or not lstm.get("row_slots_per_step") or not ctx["steps"]:
        return None
    spent = ctx["trace"].kernel_s(PATTERN)
    if spent <= 0:
        return None
    least = lc.step_bound_s(lstm["row_slots_per_step"], ctx["hidden"], ctx["elem"]) * ctx["steps"]
    return 100.0 * least / spent
