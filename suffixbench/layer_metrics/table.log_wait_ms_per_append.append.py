"""The table's ``log_wait`` span (``wait_durable``: an append's wait for
the fsync of its commit-log record) per append.  None without the
span."""


def read(ctx):
    total, n = ctx.counters.get("table.log_wait", (0.0, 0))
    return total / n if n else None
