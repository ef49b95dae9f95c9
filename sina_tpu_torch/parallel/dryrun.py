"""A dry run of the port's multi-device path on a list of devices.

Port of __graft_entry__.py dryrun_multichip: builds a (dp, mp) mesh
over the devices and runs, on tiny shapes, (1) the sharded k-mer search
(index over "mp", queries over "dp"), (2) the graph DP and its
traceback data-parallel over the flat device list, which must equal one
device's run, and (3) the sharded search at the scale of SILVA NR on a
zero-filled tiled index.  The device list may name one device more than
once, as the tests and chip_smoke.py do (the JAX package's tests use
virtual CPU devices).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graft_entry import tiny_problem
from ..ops import kmer_kernel as kk
from ..ops.align_kernel import DpParams
from ..ops.graph_kernel import (
    graph_dp, graph_traceback, pack_graph_host, pick_k_ring,
)
from .sharding import make_mesh, place_shards, shard_index_matrix, sharded_search


def _graph_dp_rows(g, n_real: int, qm: np.ndarray, ql: np.ndarray, device):
    """The graph DP and its traceback of every query row against the
    graph g, on `device`: (best_j, best_i, raw, emit) on the host."""
    B = qm.shape[0]

    def rows(a):
        return np.repeat(a[None], B, axis=0)

    mask, predbits, flags = pack_graph_host(
        rows(g.mask), rows(g.preds), rows(g.is_start), rows(g.is_end),
        np.full(B, n_real, dtype=np.int64))
    v = g.preds >= 0
    maxd = int((np.arange(g.n_nodes)[:, None] - g.preds)[v].max())
    k_ring = pick_k_ring(maxd)
    if not k_ring:
        raise AssertionError(f"predecessor distance {maxd} does not fit the graph DP kernel")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    flags_d = up(flags)
    bp, bj, bi, raw = graph_dp(
        up(rows(g.pos)), up(mask), up(rows(g.weight)), up(predbits), flags_d,
        up(qm), up(ql), up(np.ones((B, g.width + 2), dtype=np.float32)),
        params=DpParams(), k_ring=k_ring)
    emit, _ = graph_traceback(bp, bj, bi, flags_d)
    return [t.cpu() for t in (bj, bi, raw, emit)]


def dryrun_multichip(devices) -> None:
    """Run the three steps over `devices` (torch devices; CUDA ones run
    the kernels, CPU ones their plain versions); raises on a wrong
    shape or a result that differs from one device's."""
    devices = [torch.device(d) for d in devices]
    mesh = make_mesh(devices)
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]

    P, kmers, g, n_real, qm, ql = tiny_problem(n_seqs=8 * mp, n_queries=4 * dp)
    # pad the packed byte axis to whole 4-byte words a shard (the
    # scorer kernel copies 4-byte words)
    Sb = P.shape[1]
    Sb_pad = -(-Sb // (4 * mp)) * (4 * mp)
    P = np.pad(P, ((0, 0), (0, Sb_pad - Sb)))

    # 1) sharded famfinder: index sharded over "mp", queries over "dp"
    vals, ids = sharded_search(mesh, k_top=8)(shard_index_matrix(mesh, P), kmers)
    if tuple(vals.shape) != (kmers.shape[0], 8):
        raise AssertionError(f"sharded search returned {tuple(vals.shape)}")
    one = kk.score_topk(torch.from_numpy(P).to(devices[0]),
                        torch.from_numpy(kmers).to(devices[0]), 8)
    if not torch.equal(vals.cpu(), one[:, :8].cpu()):
        raise AssertionError("sharded top-k values differ from one device's")

    # 2) data-parallel graph DP over the whole device list (dp*mp on
    # the batch axis), each device its slice of the padded batch
    n = len(devices)
    B = qm.shape[0]
    B_pad = -(-B // n) * n
    qm_p = np.zeros((B_pad, qm.shape[1]), dtype=np.uint8)
    qm_p[:B] = qm
    ql_p = np.ones(B_pad, dtype=np.int32)
    ql_p[:B] = ql
    b = B_pad // n
    parts = [_graph_dp_rows(g, n_real, qm_p[i * b:(i + 1) * b], ql_p[i * b:(i + 1) * b], dev)
             for i, dev in enumerate(devices)]
    split = [torch.cat(ts) for ts in zip(*parts)]
    whole = _graph_dp_rows(g, n_real, qm_p, ql_p, devices[0])
    if not all(torch.equal(a, w) for a, w in zip(split, whole)):
        raise AssertionError("the data-parallel graph DP differs from one device's run")
    print(f"dryrun_multichip ok: mesh dp={dp} mp={mp}, search {tuple(vals.shape)}, "
          f"dp-aligned {tuple(split[2].shape)} equal to one device's")

    # 3) SILVA-NR-scale sharded famfinder (the reference's own database
    # size, README.rst:33): the bitpacked index is 262,145 x 65,536
    # bytes = 17.2 GB in the tiled layout, sharded over "mp"; a
    # zero-filled index validates shapes, launches and the merge, not
    # numerics.  On the card at the true shapes, on the CPU at 1/10
    on_card = devices[0].type == "cuda"
    n_seqs_nr, n_rows, n_km = (450_000, 4 ** 9 + 1, 512) if on_card else (45_000, 4 ** 6 + 1, 64)
    sb = -(-n_seqs_nr // 8)
    bm = 4096 * mp
    sb_pad = -(-sb // bm) * bm
    # each shard made on its own device, never as one host array
    big = place_shards(
        mesh, (n_rows, 32, sb_pad // 32), torch.uint8,
        lambda s, dev: torch.zeros((n_rows, sb_pad // mp), dtype=torch.uint8, device=dev))
    km_nr = np.full((4 * dp, n_km), n_rows - 1, dtype=np.int32)
    km_nr[:, :16] = np.arange(16)[None, :]
    v2, i2 = sharded_search(mesh, k_top=40)(big, km_nr)
    if tuple(v2.shape) != (km_nr.shape[0], 40) or bool((v2 != 0).any()):
        raise AssertionError("NR-scale sharded search: wrong shape or a nonzero score")
    del big
    scale = "TRUE 450k shapes" if on_card else f"cpu-scaled shapes ({n_seqs_nr} seqs, same sharding)"
    print(f"dryrun NR-scale sharded search ok [{scale}]: tiled index "
          f"{n_rows}x32x{sb_pad // 32} over mp={mp}, topk {tuple(v2.shape)}")
