"""The planner's ``dispatch_*`` spans (``dispatch_single``,
``dispatch_fm``, ``dispatch_fused``: the search launch and what it
waits for) over the patterns answered."""


def read(ctx):
    spans = [v for k, v in ctx.counters.items()
             if k.startswith("table.dispatch_")]
    total = sum(s for s, _n in spans)
    n = sum(c for _s, c in spans)
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
