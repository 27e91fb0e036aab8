"""Mean time a query waits in the scheduler's coalesce window (the
client's ``coalesce_wait`` span, its sum over its count)."""


def read(ctx):
    total, n = ctx.counters.get("client.coalesce_wait", (0.0, 0))
    return total / n if n else None
