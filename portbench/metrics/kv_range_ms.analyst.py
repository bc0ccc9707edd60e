"""The text island's range scan: the mean duration of the window's
``kv/range`` spans (``KVTable.range``, opened around the scan inside the
text shim).  Host work in Python with no device work of its own, so the
host clock is its sound source."""
LAYER = "shims"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(ctx, out):
    scans = [s.duration for s in ctx.spans if s.name == "kv/range"]
    if not scans:
        return None
    return sum(scans) / len(scans) * 1e3
