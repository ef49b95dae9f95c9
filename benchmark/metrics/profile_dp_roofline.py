"""The profile DP kernel's share of its roofline, in %: the least time
its window's launches need (benchlib.bounds: the instructions of each
row's real query positions x profile columns, or the bytes of its
inputs and its backpointer plane, whichever bounds it) over the device
time of profile_dp_kernel in the trace."""

from benchlib import bounds


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    t = sum(v[0] for n, v in tr["kernels"].items() if "profile_dp_kernel" in n)
    launches = tr["launches"].get("profile_dp", [])
    if not launches or t <= 0:
        return None
    need = 0.0
    for lens, U, C, M in launches:
        lens = lens.long().cpu()
        B = lens.shape[0]
        nbytes = U * C * 6 + B * M + B * 8 + C * B * M + 12 * B
        need += bounds.bound(nbytes, insts=bounds.profile_insts(lens[:, 0], lens[:, 1]))["bound_s"]
    return 100.0 * need / t
