"""Seconds a traced request spends building the bought-pair table on the
host: the mean of the program's ``gnn.serve.bought_table`` spans
(``inference.py:inference_ondemand``: ``already_bought_from_graph`` and
``build_padded_pair_set``)."""

SPAN = "gnn.serve.bought_table"


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    spans = ctx["trace"].span_s(SPAN)
    return sum(spans) / len(spans) if spans else None
