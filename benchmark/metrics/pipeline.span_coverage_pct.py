"""Share, in %, of the window (the last `pipeline.run` span) that its
child spans on the pipeline's thread cover: what the program's spans
can name of the host's time.  None where the program records no
spans."""


def read(ctx):
    from sina_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    spans = timing.spans()
    run = next((s for s in reversed(spans) if s.name == "pipeline.run"), None)
    if run is None or run.t1 <= run.t0:
        return None
    covered, end = 0, run.t0
    for s in spans:
        if s.parent == run.id and s.t1 > end:
            covered += s.t1 - max(s.t0, end)
            end = s.t1
    return 100.0 * covered / (run.t1 - run.t0)
