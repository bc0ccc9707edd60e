"""``quant_cast``'s share of its roofline on the quant route: the least
time its quantize launches could take (each float32 value read once,
its int8 code and each 128-value block's float32 scale written once,
over the card's bandwidth) over the device time of its kernels in the
trace.  The elements are those of one waveform record, as generated."""
from portbench.core.peaks import bound_seconds

LAYER = "kernels"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "query_p95_ms"
KERNEL = r"(?<!de)quantize_rows\b"
TILE = 8 * 128                    # the kernel pads to whole 8 x 128 tiles


def read(ctx, out):
    layer = out.get("layer", {})
    calls = layer.get("kinds", {}).get("quant_route", 0)
    if ctx.dtrace is None or not calls:
        return None
    launches, seconds = ctx.dtrace.matching(KERNEL)
    if launches != calls or seconds <= 0:
        return None
    n = -(-layer["quant_elements"] // TILE) * TILE
    return 100.0 * bound_seconds(calls * (n * 4 + n + n // 128 * 4)) \
        / seconds
