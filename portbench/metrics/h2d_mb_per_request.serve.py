"""Megabytes a request copies from host memory to the card: the program's
counters ``to_device.h2d_bytes`` (``utils/profiling.py``, every copy the
request issues) over ``inference_ondemand.requests``, over every request
of the process (each request moves the same run).  This reader imports the
program, where the counters live; a program without them gives nothing."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    try:
        from gnn_recsys_tpu_torch.inference import inference_ondemand
        from gnn_recsys_tpu_torch.utils.profiling import to_device
    except ImportError:
        return None
    requests = getattr(inference_ondemand, "requests", 0)
    moved = getattr(to_device, "h2d_bytes", None)
    if not requests or moved is None:
        return None
    return moved / requests / 1e6
