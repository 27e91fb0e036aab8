"""Patterns answered over the whole window, over its seconds (from the
first request's start to the last answer's arrival)."""


def read(w):
    return w.patterns / w.seconds
