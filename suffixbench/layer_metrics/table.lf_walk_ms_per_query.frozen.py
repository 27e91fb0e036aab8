"""The table's ``lf_walk`` span (inside ``merge`` on a frozen table: the
LF walks to text positions and their minimum, through the host copy
that waits for them) over the patterns answered."""


def read(ctx):
    total, n = ctx.counters.get("table.lf_walk", (0.0, 0))
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
