"""Device milliseconds a traced request of the MLP head's ranking: the
operations that the program's ``gnn.pred.rank`` spans launched
(``retrieval/recs.py:make_mlp_score_fn``, a span a chunk of users against
the whole catalog) in the traced requests' window, over those requests
(``drivers/ondemand_ranked.py``, ``harness/trace_ops.py``).  Nothing where
the program has no such span."""


def read(ctx):
    head = ctx.get("pred_rank") if ctx.get("kind") == "serve" else None
    if not head or not head["spans"]:
        return None
    return head["ms_per_request"]
