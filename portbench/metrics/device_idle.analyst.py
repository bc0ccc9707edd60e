"""The card's idle share over the traced window: no kernel, copy or set
running on it (``torch.profiler``'s CUDA activity)."""
LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "query_p95_ms"


def read(ctx, out):
    if ctx.dtrace is None or ctx.dtrace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.dtrace.busy_s() / ctx.dtrace.window_s)
