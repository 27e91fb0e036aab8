"""The table's ``dispatch`` span less its ``dispatch_*`` children over
the patterns answered: with delta tiers live, what a read does around
the fused search launch: the tier snapshot it rebuilds after a write
(the memtable's suffix sort, the stacked tier arrays built on the host
and copied to the card) and the delta tiers' match positions, gathered
and sorted on the host.  None without the span."""


def read(ctx):
    total, n = ctx.counters.get("table.dispatch", (0.0, 0))
    if not n or not ctx.segment_patterns:
        return None
    inner = sum(v[0] for k, v in ctx.counters.items()
                if k.startswith("table.dispatch_"))
    return (total - inner) / ctx.segment_patterns
