"""Device milliseconds a training step in the kernels that the frozen name
classifier (``harness/trace.py``) calls elementwise."""

from portbench.harness.trace import kernel_group


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    s = ctx["trace"].kernel_s(lambda n: kernel_group(n) == "elementwise")
    return 1e3 * s / ctx["steps"] if s > 0 else None
