"""Records written in the window over the window's whole time, in
seq/s: the host-paced rate, read per layer since it spreads with the
host's speed (PERF.md section 2)."""


def read(ctx):
    return ctx["records"] / ctx["window_s"]
