"""Share of string lookups the table's LRU pattern cache answers
(``TopKCache`` hits over hits and misses), in percent."""


def read(ctx):
    hits, misses = ctx.counters["cache.hits"], ctx.counters["cache.misses"]
    return 100.0 * hits / (hits + misses) if hits + misses else None
