"""Seconds from the seeded bases in host memory to a table that serves:
``Database.create_table`` (the suffix array and its snapshot), and
``Database.freeze`` on a frozen configuration (the FM index, built in
host numpy, and its snapshot).  The paper's pre-processing."""


def read(ctx):
    return ctx.window.ingest_s
