"""Seconds from the start of the process to the start of the window:
imports, kernel builds, the bases, the ingest and the warm-up."""


def read(w):
    return w.setup_s
