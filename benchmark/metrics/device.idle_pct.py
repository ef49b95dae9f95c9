"""Share of the traced window, in %, in which no kernel, copy or memset
ran on the device (the union of their intervals in the profiler's
trace, compute and copy streams together)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
