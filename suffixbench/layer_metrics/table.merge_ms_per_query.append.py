"""The table's ``merge`` span (text-order ``first_pos``: the base's
range minimum or k-mer entry, then the delta tiers' positions; host time
with the waits it forces) over the patterns answered:
``table.merge_ms_per_query`` of the writing cells, which report
``queries_per_s.append``."""


def read(ctx):
    total, n = ctx.counters.get("table.merge", (0.0, 0))
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
