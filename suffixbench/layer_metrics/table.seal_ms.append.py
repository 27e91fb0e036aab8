"""The table's ``seal`` span (``minor_compact``: the memtable sealed into
a run and the table's snapshot published, then the commit log sealed)
per seal.  None without a seal span."""


def read(ctx):
    total, n = ctx.counters.get("table.seal", (0.0, 0))
    return total / n if n else None
