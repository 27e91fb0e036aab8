"""Seconds from the seeded bases in host memory to a frozen table that
serves: ``Database.create_table`` and ``Database.freeze`` (the FM index,
built in host numpy, and its snapshot), bounded apart from the live
cells' ``ingest_s``."""


def read(w):
    return w.ingest_s
