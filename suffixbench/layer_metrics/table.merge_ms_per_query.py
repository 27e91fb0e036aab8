"""The table's ``merge`` span (text-order ``first_pos``: a range minimum
a query on a live table, the LF walks on a frozen one; host time with
the waits it forces) over the patterns answered."""


def read(ctx):
    total, n = ctx.counters.get("table.merge", (0.0, 0))
    return total / ctx.segment_patterns if n and ctx.segment_patterns \
        else None
