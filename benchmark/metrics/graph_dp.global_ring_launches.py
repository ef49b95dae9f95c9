"""Graph DP launches in the window (the counters' deltas across the
last `pipeline.run` span) whose predecessor ring did not fit shared
memory and took the global-ring route (csrc/graph_dp.cu).  None where
the program records no spans.  It waits for a graph cell."""


def read(ctx):
    from sina_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    run = next((s for s in reversed(timing.spans()) if s.name == "pipeline.run"), None)
    if run is None or run.counters is None:
        return None
    c0, c1 = run.counters
    return c1.get("graph_dp.global_ring", 0) - c0.get("graph_dp.global_ring", 0)
