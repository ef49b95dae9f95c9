"""Host ms a batch in family selection: every section of the port's
`Kmer Search` timer (k-mer extraction, score dispatch, the top-k fetch,
the policy), over the window's batches."""


def read(ctx):
    secs = ctx["timers"].get("Kmer Search")
    return None if not secs or not ctx["batches"] else \
        1e3 * sum(v for v, _ in secs.values()) / ctx["batches"]
