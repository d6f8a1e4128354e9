"""Seconds a traced request spends in ``load_run``: the mean of the
harness's host spans around the call (``drivers/ondemand.py:SPANS``)."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    spans = ctx["trace"].span_s("portbench.serve.load_run")
    return sum(spans) / len(spans) if spans else None
