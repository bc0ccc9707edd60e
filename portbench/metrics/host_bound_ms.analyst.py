"""The card's idle time that the program's host work accounts for, a
query: the part of the traced window in which some program span was
open (the union of every span, on any thread, laid on the device trace's
clock by its ``start_ns``) and no kernel, copy or set ran on the card,
over the window's queries.  The harness's own work between queries falls
outside the spans and is not counted."""
LAYER = "host"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "query_p95_ms"


def _union(intervals, t0, t1):
    """Disjoint, sorted intervals covering ``intervals`` within
    ``[t0, t1]``."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b):
    """Length of the intersection of two disjoint, sorted interval
    lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx, out):
    queries = out.get("layer", {}).get("queries", 0)
    dt = ctx.dtrace
    if dt is None or dt.window_s <= 0 or not queries:
        return None
    spans = [(s.start_ns, s.start_ns + round(s.duration * 1e9))
             for s in ctx.spans if getattr(s, "start_ns", 0) > 0]
    if not spans:
        return None
    host = _union(spans, dt.t0_ns, dt.t1_ns)
    busy = _union([(s, e) for s, e, _ in dt.intervals], dt.t0_ns, dt.t1_ns)
    idle_ns = sum(e - s for s, e in host) - _overlap(host, busy)
    return idle_ns / 1e6 / queries
