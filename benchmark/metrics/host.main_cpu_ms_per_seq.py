"""CPU time of the pipeline's main thread (the interpreter) over the
window, in ms a record written: the end-to-end CPU cost less the
native library's and torch's worker threads."""


def read(ctx):
    if not ctx["records"]:
        return None
    return ctx["cpu"]["main"] * 1e3 / ctx["records"]
