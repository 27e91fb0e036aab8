"""Queries a scheduler wave executes: ``SchedulerStats.executed`` over
``batches``, their growth over the window's untraced stretch."""


def read(ctx):
    b = ctx.counters.get("client.batches", 0)
    return ctx.counters["client.executed"] / b if b else None
