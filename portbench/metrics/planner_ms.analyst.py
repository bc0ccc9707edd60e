"""The planner's own host time a query: each ``planner/query`` span
(parse, signature, plan cache, plan choice, result assembly) less the
part its child spans (the executor's, the Migrator's) cover.  Host work
with no device work of its own, so the host clock is its sound source;
the quant route's migrations have no planner span and are not counted."""
LAYER = "planner"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(ctx, out):
    queries = [s for s in ctx.spans if s.name == "planner/query"]
    if not queries:
        return None
    ids = {s.span_id for s in queries}
    child = {}
    for s in ctx.spans:
        if s.parent_id in ids:
            child[s.parent_id] = child.get(s.parent_id, 0.0) + s.duration
    own = [s.duration - child.get(s.span_id, 0.0) for s in queries]
    return sum(own) / len(own) * 1e3
