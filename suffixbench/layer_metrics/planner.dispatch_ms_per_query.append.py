"""The planner's ``dispatch_*`` spans (with delta tiers live,
``dispatch_fused``: the base's ``bounded_search`` and the ``tier_scan``
launch and what they wait for) over the patterns answered:
``planner.dispatch_ms_per_query`` of the writing cells, which report
``queries_per_s.append``."""


def read(ctx):
    spans = [v for k, v in ctx.counters.items()
             if k.startswith("table.dispatch_")]
    total = sum(s for s, _n in spans)
    n = sum(c for _s, c in spans)
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
