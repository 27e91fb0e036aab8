"""The card's allocated-bytes peak over the window (reset at its start),
over the table's bases: how much genome one card can serve."""


def read(w):
    return w.window_peak_bytes / w.n_bases if w.window_peak_bytes else None
