"""Patterns answered over the whole window, over its seconds (from the
first request's start to the last answer's arrival): the frozen
cells' rate, bounded apart from the live cells' ``queries_per_s``."""


def read(w):
    return w.patterns / w.seconds
