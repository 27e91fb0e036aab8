"""The table's ``range_min`` span (inside ``merge`` on a live table: the
per-query reductions of each SA slice, through the host copy that waits
for them) over the patterns answered."""


def read(ctx):
    total, n = ctx.counters.get("table.range_min", (0.0, 0))
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
