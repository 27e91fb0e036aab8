"""95th percentile of request latency, from submit to the answer in the
caller's hand, over every request of the window: the frozen cells'
tail, bounded apart from the live cells' ``p95_ms``."""
import numpy as np


def read(w):
    return float(np.percentile(w.lat_ms, 95)) if w.lat_ms.size else None
