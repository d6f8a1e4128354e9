"""Device idle milliseconds a training step while the host replays the
step's CUDA graph: the idle gaps of the traced window (found as
``Trace.idle_gaps`` finds them) whose middle lies inside one of the
program's ``gnn.train.replay`` spans, summed and divided by the window's
steps."""

SPAN = "gnn.train.replay"


def gaps(tr):
    """The window's idle gaps, (start s, end s), in order."""
    out, end = [], 0.0
    for s, e, _ in sorted(tr.device):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if end < tr.window_s:
        out.append((end, tr.window_s))
    return out


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    tr = ctx["trace"]
    replays = [(s, e) for s, e, n in tr.host if n == SPAN]
    if not replays:
        return None
    idle = sum(b - a for a, b in gaps(tr)
               if any(s <= (a + b) / 2 <= e for s, e in replays))
    return 1e3 * idle / ctx["steps"]
