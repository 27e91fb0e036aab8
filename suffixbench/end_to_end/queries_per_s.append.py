"""Patterns answered over the whole window, over its seconds (from the
first request's start to the last answer's arrival), appends and all:
the writing cells' rate, bounded apart from the read-only cells'."""


def read(w):
    return w.patterns / w.seconds
