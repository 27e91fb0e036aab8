"""The table's ``tier_snapshot`` span (``TierSet.build``: the delta-tier
snapshot a read rebuilds after a write, the memtable's suffix sort and
the tiers' rows stacked on the card) over the patterns answered; part
of ``dispatch``.  None without the span."""


def read(ctx):
    total, n = ctx.counters.get("table.tier_snapshot", (0.0, 0))
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
