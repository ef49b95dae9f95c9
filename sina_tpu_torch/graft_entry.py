"""Entry points of the port for a single step and a dry run (port of
__graft_entry__.py).

entry(device) -> (fn, example_args): a single-device forward step on
the flagship compute path: batched k-mer famfinder scoring, top-k
candidate selection and the POA alignment DP, on tiny shapes.

    python -m sina_tpu_torch.graft_entry [--device cuda|cpu]

runs entry()'s step once, prints "entry ok: [shapes]", then runs
parallel.dryrun.dryrun_multichip over the visible CUDA devices (or the
CPU with --device cpu), as __graft_entry__.py's main does over
jax.devices().
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .align import _max_pred_distance
from .device import resolve_device
from .ops import kmer_kernel as kk
from .ops.align_kernel import DpParams, graph_dp_dense
from .ops.graph import build_graph, pad_graph
from .ops.kmer import query_kmers_padded
from .ops.kmer_index import KmerIndex


def tiny_problem(n_seqs=32, width=96, n_queries=8, k=4):
    """__graft_entry__.py _tiny_problem: a small reference, its packed
    k-mer index, the queries' k-mers, the graph of its first 8
    sequences padded to 128 nodes (with its node count before the
    padding), and the queries' first 64 bases as uint8 masks with
    their lengths: (P, kmers, g, n_real, qm, ql)."""
    from . import testing

    db = testing.make_reference(n_seqs=n_seqs, n_core=width // 2, width=width, seed=77)
    P = KmerIndex.build(db, k=k, fast=False).dense_packed()
    queries = [testing.unaligned_copy(q)
               for q in testing.make_queries(db, n=n_queries, seed=3)]
    kmers, _ = query_kmers_padded([q.masks for q in queries], k, fast=False, pad_to=64)
    g = build_graph(db.sequences[:8])
    n_real = g.n_nodes
    g = pad_graph(g, 128)
    qm = np.zeros((n_queries, 64), dtype=np.uint8)
    ql = np.zeros(n_queries, dtype=np.int32)
    for i, q in enumerate(queries):
        m = min(len(q.masks), 64)
        qm[i, :m] = q.masks[:m]
        ql[i] = m
    return P, kmers, g, n_real, qm, ql


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args) on `device` (CUDA unless the caller asks for
    the CPU; CUDA without a GPU raises).  fn(*example_args) returns
    (vals, ids, best_j, best_i, raw): the top 8 k-mer scores of each
    query and their reference ids, ties to the lowest id as lax.top_k
    (the bitpacked scorer, csrc/kmer_score.cu), and the end cell and raw
    score of each query's DP against the graph (the dense graph DP,
    csrc/graph_dense.cu, the port of poa_dp / poa_dp_costs).  As in the
    reference, the DP is told the padded node count (128) as the real
    one (__graft_entry__.py:56,68)."""
    dev = resolve_device(device)
    P, kmers, g, _, qm, ql = tiny_problem()
    B = kmers.shape[0]
    params = DpParams()
    maxd = _max_pred_distance(g)

    def step(P, kmers, pos, mask, weight, preds, is_start, is_end, qm, ql, n_real, cw):
        vals, ids = kk.top_k_lowest_id(kk.kmer_scores(P, kmers), 8)
        _, bj, bi, raw = graph_dp_dense(pos, mask, weight, preds, is_start, is_end,
                                        qm, ql, n_real, cw, params, maxd=maxd)
        return vals, ids, bj, bi, raw

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rows(a):
        # the graph once a query (the reference vmaps over the queries)
        return up(np.repeat(np.asarray(a)[None], B, axis=0))

    args = (
        up(P), up(kmers),
        rows(g.pos), rows(g.mask), rows(g.weight), rows(g.preds),
        rows(g.is_start), rows(g.is_end),
        up(qm), up(ql), up(np.full(B, g.n_nodes, dtype=np.int32)),
        rows(np.ones(g.width + 2, dtype=np.float32)),
    )
    return step, args


def main(argv=None) -> int:
    from .parallel.dryrun import dryrun_multichip  # which imports tiny_problem from here

    ap = argparse.ArgumentParser(prog="python -m sina_tpu_torch.graft_entry")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; every visible CUDA device joins the dry run) "
                         "or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fn, example = entry(dev)
    out = fn(*example)
    print("entry ok:", [tuple(o.shape) for o in out])
    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    dryrun_multichip(devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
