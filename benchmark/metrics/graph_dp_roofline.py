"""The graph DP kernel's share of its roofline, in %: the least time
its window's launches need (benchlib.bounds: the instructions of each
query's real nodes x query positions, of the predecessors each node
probes, of its nodes and end cells, or the bytes of its operands and
its backpointer plane, whichever bounds it) over the device time of
graph_dp_kernel in the trace."""

import torch

from benchlib import bounds


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    t = sum(v[0] for n, v in tr["kernels"].items() if "graph_dp_kernel" in n)
    launches = tr["launches"].get("graph_dp", [])
    if not launches or t <= 0:
        return None
    need = 0.0
    for predbits, flags, qlen, M, nbytes in launches:
        flags, ql = flags.long().cpu(), qlen.long().cpu()
        pb = predbits.long().cpu() & 0xFFFFFFFF
        B, N = flags.shape
        real = (flags & 4) != 0
        npred = torch.zeros_like(pb)
        for d in range(32):
            npred += (pb >> d) & 1
        n_real = real.sum(dim=1)
        n_end = (((flags & 6) == 6) & real).sum(dim=1)
        insts = bounds.graph_insts(int((n_real * ql).sum()),
                                   int(((npred * real).sum(dim=1) * ql).sum()),
                                   int(n_real.sum()), int((n_end * ql).sum()))
        need += bounds.bound(nbytes + B * N * M * 2 + 12 * B, insts=insts)["bound_s"]
    return 100.0 * need / t
