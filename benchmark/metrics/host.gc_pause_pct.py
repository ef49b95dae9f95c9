"""Share of the window, in %, the interpreter spent in generation-2
garbage collections (gc.callbacks)."""


def read(ctx):
    return 100.0 * ctx["gc"][2][1] / ctx["window_s"]
