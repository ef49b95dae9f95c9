"""Host ms a batch in the aligner's finish (NAST placement, overhangs,
attributes): the `finish` sections of the Aligner (profile engine) and
GraphDP (graph engine) timers, over the window's batches."""


def read(ctx):
    t = ctx["timers"]
    secs = [t.get(n, {}).get("finish") for n in ("Aligner", "GraphDP")]
    secs = [s[0] for s in secs if s is not None]
    return None if not secs or not ctx["batches"] else 1e3 * sum(secs) / ctx["batches"]
