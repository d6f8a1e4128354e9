"""The MLP head's share of its roofline while it ranks: the least time of
the traced requests' head (``counts/serve_ranked.py:head_bound_s``: layer 1
factorised over each request's listed users and the catalog's items, layers
2 and 3 on the pairs that the program's ``make_mlp_score_fn.pairs`` counter
counted, the rows read and the f32 scores written, at the f32 peak) over the
head's device time that ``pred_nn_rank_ms.serve`` reads, in percent.
Nothing where the program has no such span or counter."""

from portbench.counts import serve_ranked as cs


def read(ctx):
    head = ctx.get("pred_rank") if ctx.get("kind") == "serve" else None
    if not head or not head["spans"] or not head["pairs"] or head["ms_per_request"] <= 0:
        return None
    spent = head["ms_per_request"] * head["requests"] / 1e3
    return 100.0 * cs.head_bound_s(head["users"], head["items"], head["pairs"],
                                   head["out"]) / spent
