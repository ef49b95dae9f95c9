"""Host ms a batch in the pipeline's writer and statistics (the Pipeline
timer's `write+stats` section), over the window's batches."""


def read(ctx):
    s = ctx["timers"].get("Pipeline", {}).get("write+stats")
    return None if s is None or not ctx["batches"] else 1e3 * s[0] / ctx["batches"]
