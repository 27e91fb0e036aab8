"""95th percentile of read-batch latency, from submit to the answer in
the caller's hand, over every read of the window: the writing cells'
tail, bounded apart from the read-only cells'."""
import numpy as np


def read(w):
    return float(np.percentile(w.lat_ms, 95)) if w.lat_ms.size else None
