"""How much of the text island's range scan is wasted work: the keys the
scans compared against their bounds over the rows they returned, summed
over the window's ``kv/range`` spans (their ``examined`` and ``rows``).
A scan of every key reads the table's size over the mean rows; one that
finds its bounds by bisection reads about 1."""
LAYER = "shims"
SOURCE = "program_span"
UNIT = "keys/row"
MOVES = "query_p95_ms"


def read(ctx, out):
    scans = [s.attrs for s in ctx.spans
             if s.name == "kv/range" and "examined" in s.attrs]
    rows = sum(a["rows"] for a in scans)
    if not rows:
        return None
    return sum(a["examined"] for a in scans) / rows
