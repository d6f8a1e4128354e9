"""The share of the traced requests' window in which no operation ran on
the device, in percent."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
