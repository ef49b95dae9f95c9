"""95th percentile, in ms, of the host time spent on one batch over the
window's batches: for each batch id, the self time (duration less its
child spans') of every program span in the window (the last
`pipeline.run` span) that carries the id, from its read to its write.
None where the program records no spans."""

from collections import defaultdict

import numpy as np


def read(ctx):
    from sina_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    spans = timing.spans()
    run = next((s for s in reversed(spans) if s.name == "pipeline.run"), None)
    if run is None:
        return None
    inside = [s for s in spans if run.t0 <= s.t0 and s.t1 <= run.t1 and s is not run]
    child = defaultdict(int)
    for s in inside:
        child[s.parent] += s.t1 - s.t0
    host = defaultdict(int)
    for s in inside:
        if s.batch is not None:
            host[s.batch] += s.t1 - s.t0 - child[s.id]
    if not host:
        return None
    return float(np.percentile(list(host.values()), 95)) * 1e-6
