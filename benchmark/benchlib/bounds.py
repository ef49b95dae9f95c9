"""The least time the card could take for a kernel's work, counted from
its inputs: frozen copies of chip_smoke.py's bound arithmetic
(``bound`` chip_smoke.py:420, ``kmer_bound`` :822, the DPs'
instruction counts :276-327), so that the benchmark reads the same work
whatever kernel does it.  Peaks: NVIDIA's H100 SXM data sheet at 700 W.
"""

from __future__ import annotations

import torch

# device memory bytes/s and float32 operations/s outside the tensor
# cores (a multiply-add counts two)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the DPs are counted in thread instructions: 128 an SM a clock (the
# f32 add, min, compare and select rate), integer ones at half that
ISSUE_PER_S = F32_OPS_PER_S / 2
INT32_PER_S = ISSUE_PER_S / 2
# (all, integer) instructions of ops/profile_kernel.py profile_dp_plain
# per real column x query position, per real column, per query position
PROFILE_INSTS_PER_CELL = (27, 7)
PROFILE_INSTS_PER_COLUMN = (16 + 16 * 11 + 3, 1)
PROFILE_INSTS_PER_POSITION = (3, 1)
# ops/graph_kernel.py _graph_core_plain: per real node x query position,
# per predecessor probe of a cell, per real node, per end node x position
GRAPH_INSTS_PER_CELL = (24, 9)
GRAPH_INSTS_PER_PRED_CELL = (11, 3)
GRAPH_INSTS_PER_NODE = (8, 1)
GRAPH_INSTS_PER_END_CELL = (4, 1)


def bound(nbytes: float, nops: float = 0.0, insts: tuple = (0, 0)) -> dict:
    """The least seconds for work that moves `nbytes` of device memory
    (each input read once, each output written once) and does `nops`
    f32 operations, or `insts` = (all, integer) instructions, and which
    of the two bounds it."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = max(nops / F32_OPS_PER_S, insts[0] / ISSUE_PER_S, insts[1] / INT32_PER_S)
    return {"bound_s": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def kmer_bound(kmers: torch.Tensor, Sb: int, sink: int) -> dict:
    """The bitpacked scorer's bound: the batch's distinct rows read once,
    the ids, the scores written once; one add per reference for each
    distinct row of a query but the all-zero sink row."""
    B, L = kmers.shape
    rows = int(torch.unique(kmers).numel())
    s = kmers.sort(dim=1).values
    distinct = (1 + (s[:, 1:] != s[:, :-1]).sum(dim=1) - (s == sink).any(dim=1).int())
    return bound(rows * Sb + 4 * kmers.numel() + 4 * B * 8 * Sb, int(distinct.sum()) * 8 * Sb)


def profile_insts(ql, cr) -> tuple:
    """The profile DP's (all, integer) instructions over rows of real
    query lengths `ql` and profile columns `cr` (int64 tensors)."""
    counts = (int((ql * cr).sum()), int(cr.sum()), int(ql.sum()))
    per = (PROFILE_INSTS_PER_CELL, PROFILE_INSTS_PER_COLUMN, PROFILE_INSTS_PER_POSITION)
    return tuple(sum(n * p[k] for n, p in zip(counts, per)) for k in (0, 1))


def graph_insts(cells: int, pred_cells: int, nodes: int, end_cells: int) -> tuple:
    counts = (cells, pred_cells, nodes, end_cells)
    per = (GRAPH_INSTS_PER_CELL, GRAPH_INSTS_PER_PRED_CELL, GRAPH_INSTS_PER_NODE,
           GRAPH_INSTS_PER_END_CELL)
    return tuple(sum(n * p[k] for n, p in zip(counts, per)) for k in (0, 1))
