"""Host ms a batch spent handing the DPs to the device: the ProfileDP
timer's sections (pack, h2d, launch) and the GraphDP timer's but its
fetch and finish (stack, pack, launch), over the window's batches."""


def read(ctx):
    t = ctx["timers"]
    s = sum(v for v, _ in t.get("ProfileDP", {}).values())
    s += sum(v for k, (v, _) in t.get("GraphDP", {}).items() if k not in ("fetch", "finish"))
    return None if s == 0 or not ctx["batches"] else 1e3 * s / ctx["batches"]
