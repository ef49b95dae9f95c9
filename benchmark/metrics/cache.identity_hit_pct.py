"""Share, in %, of the lookups of the aligner's identity-keyed caches
(sina_tpu_torch.cache.IdentityCache: normalised bases, the database's
occupied columns, anchor tables) that hit, over the window (the
counters' deltas across the last `pipeline.run` span).  None where no
lookup was made in the window, or the program counts none: these
caches serve the string copy path and column trimming, which no cell
takes yet."""


def read(ctx):
    from sina_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    run = next((s for s in reversed(timing.spans()) if s.name == "pipeline.run"), None)
    if run is None or run.counters is None:
        return None
    c0, c1 = run.counters
    hits = misses = 0
    for k, v in c1.items():
        if k.startswith("cache.") and k.endswith(".hit"):
            hits += v - c0.get(k, 0)
        elif k.startswith("cache.") and k.endswith(".miss"):
            misses += v - c0.get(k, 0)
    return 100.0 * hits / (hits + misses) if hits + misses else None
