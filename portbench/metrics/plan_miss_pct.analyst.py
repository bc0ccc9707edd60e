"""The plan cache's misses: the share of the window's ``planner/query``
spans that consulted the cache (those with a ``cache`` attribute: lean
queries, not the catalog's) whose lookup was not a ``hit`` (a ``miss``,
or a ``stale`` entry dropped for its age or a newer Monitor
measurement).  Each miss plans the query afresh."""
LAYER = "planner"
SOURCE = "program_span"
UNIT = "%"
MOVES = "query_p95_ms"


def read(ctx, out):
    looked = [s.attrs["cache"] for s in ctx.spans
              if s.name == "planner/query" and "cache" in s.attrs]
    if not looked:
        return None
    return 100.0 * sum(c != "hit" for c in looked) / len(looked)
