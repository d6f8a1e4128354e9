"""The share of the traced training window in which no operation ran on
the device, in percent."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
