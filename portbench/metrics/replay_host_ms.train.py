"""Host milliseconds of one CUDA-graph replay of the training step: the
mean of the program's ``gnn.train.replay`` spans in the traced window
(``train/graph_step.py:CapturedStep.replay``: the learning rates' fill,
the graph's launch, Adam's host half).  Near the whole step where the
launch waits for the replay before it."""

SPAN = "gnn.train.replay"


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    spans = ctx["trace"].span_s(SPAN)
    return 1e3 * sum(spans) / len(spans) if spans else None
