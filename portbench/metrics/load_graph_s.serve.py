"""Seconds a traced request spends reading and rebuilding the run's graph:
the mean of the program's ``gnn.load_run.graph`` spans
(``train/checkpoint.py:load_run`` around ``graph/serialize.py:load_graph``)."""

SPAN = "gnn.load_run.graph"


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    spans = ctx["trace"].span_s(SPAN)
    return sum(spans) / len(spans) if spans else None
