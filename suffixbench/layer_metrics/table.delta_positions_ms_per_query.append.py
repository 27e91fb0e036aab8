"""The table's ``delta_positions`` span (the delta tiers' positions of a
read: with ``top_k`` 0 each query's first one, from the fused scan's
``first_g``; else every match, gathered and sorted on the host) over
the patterns answered; part of ``dispatch``.  None without the span."""


def read(ctx):
    total, n = ctx.counters.get("table.delta_positions", (0.0, 0))
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
