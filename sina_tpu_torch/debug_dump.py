"""Full-lattice alignment debug dump (--debug-lattice).

Port of sina_tpu/debug_dump.py.  The reference's mesh_debug
(mesh_debug.h:103-193, ``mesh_to_svg``) renders a column range of the
DP mesh as a graphviz table: one cell per (master node, slave base)
with the cell value, the delta to its backpointer cell, the gap-track
values and the node/base labels, plus the backpointer edges.  The
lattice normally never leaves the device; this module re-runs the
dense graph DP (ops/align_kernel.poa_dp_dense with
``return_lattice=True``) for ONE query on the device its caller gives
and emits the same dump: a debug tool for small regions, not a
production path.
"""

from __future__ import annotations

import numpy as np
import torch

from . import alphabet
from .ops import align_kernel as ak
from .ops.graph import LinearGraph, build_graph
from .sequence import Sequence

CODE_NAMES = {
    ak.CODE_EDGE: "edge",
    ak.CODE_MATCH: "match",
    ak.CODE_DEL: "del",
    ak.CODE_INS: "ins",
}


def compute_lattice(
    graph: LinearGraph,
    query: Sequence,
    params: ak.DpParams | None = None,
    col_weights: np.ndarray | None = None,
    device: torch.device | str = "cuda",
):
    """Run the dense DP for one query on `device` and return
    (bp (N, M) uint16, best_j, best_i, raw, V (N, M), D (N, M))."""
    params = params or ak.DpParams()
    m = len(query.masks)
    n = graph.n_nodes
    cw = (
        col_weights
        if col_weights is not None
        else np.ones(graph.width + 2, dtype=np.float32)
    )

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)[None]).to(device)

    out = ak.poa_dp_dense(
        t(graph.pos, np.int64), t(graph.mask, np.int64),
        t(graph.weight, np.float32), t(graph.preds, np.int64),
        t(graph.is_start, np.bool_), t(graph.is_end, np.bool_),
        t(query.masks, np.int64), torch.tensor([m], device=device),
        torch.tensor([n], device=device), t(cw, np.float32), params,
        return_lattice=True,
    )
    bp, bj, bi, raw, V, D = (a[0].cpu().numpy() for a in out)
    return bp.view(np.uint16), int(bj), int(bi), float(raw), V, D


def _bp_target(bp_cell: int, preds: np.ndarray, j: int, i: int):
    """Backpointer cell (j', i') for the cell (j, i), mirroring the
    packed uint16 layout documented in ops/align_kernel.py."""
    code = bp_cell & 0x3
    if code == ak.CODE_MATCH:
        slot = (bp_cell >> 2) & 0x7
        return int(preds[j, slot]), i - 1
    if code == ak.CODE_DEL:
        slot = (bp_cell >> 5) & 0x7
        return int(preds[j, slot]), i
    if code == ak.CODE_INS:
        # an insertion "selected" at i=0 is the edge seed (the
        # insertion track ties with the edge value there)
        return (j, i - 1) if i > 0 else None
    return None  # edge cell: no predecessor


def lattice_to_dot(
    graph: LinearGraph,
    query: Sequence,
    params: ak.DpParams | None = None,
    col_from: int = 0,
    col_to: int | None = None,
    col_weights: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> str:
    """Graphviz dump of the DP lattice region whose nodes lie in
    alignment columns [col_from, col_to) (mesh_to_svg semantics:
    per-cell value, delta to the backpointer cell, gap-track values,
    node/base labels, and backpointer edges)."""
    bp, bj, bi, raw, V, D = compute_lattice(
        graph, query, params, col_weights, device
    )
    if col_to is None:
        col_to = graph.width
    nodes = [
        j
        for j in range(graph.n_nodes)
        if col_from <= int(graph.pos[j]) < col_to
    ]
    m = len(query.masks)
    lines = [
        "digraph {",
        "node [style=invis];",
        f'label="raw={raw:.3f} best=({bj},{bi})";',
    ]
    in_range = set(nodes)
    for j in nodes:
        ch = chr(alphabet.MASK_TO_RNA[graph.mask[j] & 0xF])
        for i in range(m):
            qc = chr(alphabet.MASK_TO_RNA[query.masks[i] & 0xF])
            tgt = _bp_target(int(bp[j, i]), graph.preds, j, i)
            delta = (
                V[j, i] - V[tgt[0], tgt[1]]
                if tgt is not None and tgt[0] >= 0 and tgt[1] >= 0
                else V[j, i]
            )
            code = CODE_NAMES[int(bp[j, i]) & 0x3]
            lines.append(
                f'f_{j}_{i} [style=solid,shape=plaintext,label='
                f'<<TABLE BORDER="0" CELLBORDER="1" CELLSPACING="0">'
                f"<TR><TD>{-V[j, i]:.2f} ({delta:.2f})</TD></TR>"
                f"<TR><TD>{-D[j, i]:.2f}/{code}</TD></TR>"
                f"<TR><TD>{ch}({int(graph.pos[j])})/{qc}{i}</TD></TR>"
                f"</TABLE>>];"
            )
    for j in nodes:
        for i in range(m):
            tgt = _bp_target(int(bp[j, i]), graph.preds, j, i)
            if (
                tgt is not None
                and tgt[0] in in_range
                and tgt[1] >= 0
            ):
                lines.append(f"f_{j}_{i} -> f_{tgt[0]}_{tgt[1]};")
    lines.append("}")
    return "\n".join(lines) + "\n"


def dump_lattice(
    query: Sequence,
    family: list[tuple[float, Sequence]],
    fname: str,
    col_from: int = 0,
    col_to: int | None = None,
    params: ak.DpParams | None = None,
    fs_weight: float = 1.0,
    device: torch.device | str = "cuda",
) -> None:
    """Build the family POA graph, run the dense DP for `query` on
    `device` and write the lattice-region graphviz dump to `fname`
    (the --debug-lattice CLI path; reference: mesh_to_svg calls
    guarded by its debug hooks)."""
    refs = [it[1] for it in family]
    graph = build_graph(refs, fs_weight)
    q = query.copy()
    q.upper_case_all()
    with open(fname, "w") as fh:
        fh.write(
            lattice_to_dot(
                graph, q, params, col_from, col_to, device=device
            )
        )
