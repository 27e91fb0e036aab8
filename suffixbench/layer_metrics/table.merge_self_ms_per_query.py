"""The table's ``merge`` span less its children ``range_min`` and
``lf_walk`` (the host copies of the counts and ranks, and the loop over
every row) over the patterns answered; None from a program that has
neither child span."""

CHILDREN = ("table.range_min", "table.lf_walk")


def read(ctx):
    merge, n = ctx.counters.get("table.merge", (0.0, 0))
    if not n or not ctx.segment_patterns \
            or not any(k in ctx.counters for k in CHILDREN):
        return None
    inner = sum(ctx.counters.get(k, (0.0, 0))[0] for k in CHILDREN)
    return (merge - inner) / ctx.segment_patterns
