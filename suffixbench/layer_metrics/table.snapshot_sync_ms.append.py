"""The table's ``snapshot_sync`` span (the fsyncs that put a seal's
snapshot on disk before the commit log is sealed) per seal: what the
durable ack costs a seal.  None without a seal or without the span."""


def read(ctx):
    sync, n_sync = ctx.counters.get("table.snapshot_sync", (0.0, 0))
    _seal, n = ctx.counters.get("table.seal", (0.0, 0))
    return sync / n if n and n_sync else None
