"""Seconds of set-up spent opening the reference bundle: the program's
`setup.refdb_open` spans (ReferenceDb.open) inside the last
`setup.pipeline` span (Pipeline.__init__) opened before the window,
the last `pipeline.run` span.  None where the program records no
spans."""


def read(ctx):
    from sina_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    spans = timing.spans()
    run = next((s for s in reversed(spans) if s.name == "pipeline.run"), None)
    setup = next((s for s in reversed(spans) if s.name == "setup.pipeline"
                  and run is not None and s.t1 <= run.t0), None)
    if setup is None:
        return None
    return 1e-9 * sum(s.t1 - s.t0 for s in spans if s.name == "setup.refdb_open"
                      and setup.t0 <= s.t0 and s.t1 <= setup.t1)
