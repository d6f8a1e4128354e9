"""The traced requests' model FLOPs (``counts/model.py:request``) a second
over the f32 peak, in percent: a run directory keeps no compute dtype, so
requests compute in f32."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["request_flops"]:
        return None
    return 100.0 * sum(ctx["request_flops"]) / ctx["trace"].window_s / ctx["peak_flops"]
