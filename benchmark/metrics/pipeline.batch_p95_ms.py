"""95th percentile of the gap, in ms, between consecutive batches'
records reaching the output reader (a batch reaches it with its last
record), over the window."""

import numpy as np


def read(ctx):
    stamps, b = np.asarray(ctx["stamps"]), ctx["batch_size"]
    ends = stamps[b - 1::b]
    if len(ends) < 3:
        return None
    return float(np.percentile(np.diff(ends), 95) * 1e3)
