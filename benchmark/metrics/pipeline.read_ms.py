"""Host ms a batch spent reading and parsing the input, the wait on it
included: the program's `pipeline.read` spans in the window (the last
`pipeline.run` span) over the window's batches.  None where the program
records no spans."""


def read(ctx):
    from sina_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    spans = timing.spans()
    run = next((s for s in reversed(spans) if s.name == "pipeline.run"), None)
    if run is None:
        return None
    reads = [s for s in spans if s.name == "pipeline.read" and s.parent == run.id]
    n = len({s.batch for s in reads if s.batch is not None})
    return 1e-6 * sum(s.t1 - s.t0 for s in reads) / n if n else None
