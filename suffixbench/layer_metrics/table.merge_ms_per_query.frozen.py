"""The table's ``merge`` span on a frozen table (text-order
``first_pos`` by the LF walks; host time with the waits it forces) over
the patterns answered: ``table.merge_ms_per_query`` of the frozen
cells, which report ``queries_per_s.frozen``."""


def read(ctx):
    total, n = ctx.counters.get("table.merge", (0.0, 0))
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
