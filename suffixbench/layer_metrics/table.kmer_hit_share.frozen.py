"""Share of the patterns with a base match whose ``first_pos`` the
table's k-mer table answers (the ``table.kmer_patterns`` counter), the
rest being left to ``lf_walk`` (``table.slice_patterns``), in percent.
None from a program without the counters."""


def read(ctx):
    hits = ctx.counters.get("table.kmer_patterns", (0.0, 0))[0]
    left = ctx.counters.get("table.slice_patterns", (0.0, 0))[0]
    return 100.0 * hits / (hits + left) if hits + left else None
