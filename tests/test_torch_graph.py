"""The port's graph DP and graph traceback against the JAX package.

The plain PyTorch DP (graph_kernel.graph_dp_plain) and traceback
(graph_traceback_plain) run on the same numpy inputs as the Pallas
kernel (graph_pallas.graph_dp_pallas_packed, interpret mode on the CPU)
and the XLA windowed core (align_kernel.poa_dp_batch, window=32), in
the four scoring modes: simple, random column weights, forbid
(bounded insertions) and the substitution matrix.  emit, best_j,
best_i and raw are compared exactly.  The one exception: the matrix
scheme's raw against the XLA oracle, which may differ by 1 ulp (the
XLA oracle may contract a multiply-add to FMA; see
tests/test_graph_pallas.py:306-316), is held to rtol 1e-6.  The
interpret-mode ring is the smallest power of two above the graph's
largest predecessor distance: the result does not depend on it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sina_tpu import testing
from sina_tpu.ops import align_kernel as ak
from sina_tpu.ops.align_kernel import DpParams as JaxDpParams
from sina_tpu.ops.graph import build_graph, pad_graph
from sina_tpu.ops.graph_pallas import graph_dp_pallas_packed
from sina_tpu.ops.graph_pallas import pack_graph_host as jax_pack_graph_host
from sina_tpu_torch.ops import graph_kernel as gk
from sina_tpu_torch.ops.align_kernel import DpParams

MODES = ("simple", "weighted", "forbid", "matrix")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small tensor operations: under
    the test run's parallel workers, torch's intra-op threads would
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bucket(seed: int, n_queries: int = 3):
    """Family graphs of 9 references and one query each, padded to a
    shared (N, M) bucket, as numpy arrays."""
    db = testing.make_reference(n_seqs=40, n_core=200, width=350, seed=seed)
    graphs, raw_nodes, qs = [], [], []
    for i in range(n_queries):
        g = build_graph(db.sequences[3 * i : 3 * i + 9])
        raw_nodes.append(g.n_nodes)
        graphs.append(g)
        qs.append(testing.unaligned_copy(
            testing.make_queries(db, n=1, seed=100 * seed + i, branch_len=0.6)[0]))
    npad = -(-max(g.n_nodes for g in graphs) // 64) * 64 + 16  # padding nodes
    mpad = -(-max(len(q.masks) for q in qs) // 64) * 64 + 4    # padding lanes
    graphs = [pad_graph(g, npad) for g in graphs]
    qm = np.zeros((n_queries, mpad), np.int32)
    ql = np.zeros(n_queries, np.int32)
    for b, q in enumerate(qs):
        qm[b, : len(q.masks)] = q.masks
        ql[b] = len(q.masks)
    preds = np.stack([g.preds for g in graphs])
    dists = np.arange(npad)[None, :, None] - preds
    return dict(
        pos=np.stack([g.pos for g in graphs]),
        mask=np.stack([g.mask.astype(np.int32) for g in graphs]),
        weight=np.stack([g.weight for g in graphs]),
        preds=preds,
        is_start=np.stack([g.is_start for g in graphs]),
        is_end=np.stack([g.is_end for g in graphs]),
        qm=qm, ql=ql, nr=np.asarray(raw_nodes, np.int32),
        max_insert=np.stack([np.clip(g.max_insert, 0, 10**6) for g in graphs]).astype(np.int32),
        maxd=int(dists[preds >= 0].max()), npad=npad, mpad=mpad,
        width=max(g.width for g in graphs) + 2,
    )


def _mode_inputs(c, mode: str, seed: int):
    B = len(c["ql"])
    rng = np.random.RandomState(seed)
    if mode in ("weighted", "matrix"):
        cw = rng.uniform(0.5, 2.0, size=(B, c["width"])).astype(np.float32)
    else:
        cw = np.ones((B, c["width"]), np.float32)
    max_ins = c["max_insert"] if mode == "forbid" else None
    subst = (rng.uniform(-2, 2, size=(B, 4, 4)).astype(np.float32)
             if mode == "matrix" else None)
    return cw, max_ins, subst


def _port(c, cw, max_ins, subst, params: DpParams):
    mask_u8, predbits, flags = gk.pack_graph_host(
        c["mask"], c["preds"], c["is_start"], c["is_end"], c["nr"])
    t = torch.from_numpy
    bp, bj, bi, raw = gk.graph_dp_plain(
        t(c["pos"]), t(mask_u8), t(c["weight"]), t(predbits), t(flags),
        t(c["qm"].astype(np.uint8)), t(c["ql"]), t(cw),
        None if max_ins is None else t(max_ins),
        None if subst is None else t(subst),
        params=params, k_ring=gk.pick_k_ring(c["maxd"]))
    emit, done = gk.graph_traceback_plain(bp, bj, bi, t(flags))
    assert done.tolist() == [1] * len(done)
    return [a.numpy() for a in (emit, bj, bi, raw)]


def _pallas(c, cw, max_ins, subst, params: JaxDpParams):
    mask_u8, predbits, flags = jax_pack_graph_host(
        c["mask"], c["preds"], c["is_start"], c["is_end"], c["nr"])
    k = 8
    while k <= c["maxd"]:
        k *= 2
    j = jnp.asarray
    out = graph_dp_pallas_packed(
        j(c["pos"]), j(mask_u8), j(c["weight"]), j(predbits), j(flags),
        j(c["qm"]), j(c["ql"]), j(cw),
        None if max_ins is None else j(max_ins),
        None if subst is None else j(subst),
        n_nodes=c["npad"], m_len=c["mpad"], k_ring=k, params=params,
        interpret=True)
    return [np.asarray(a) for a in out]


def _xla(c, cw, max_ins, subst, params: JaxDpParams):
    j = jnp.asarray
    if subst is not None:
        out = ak.poa_dp_subst_batch(
            j(c["pos"]), j(c["mask"]), j(c["preds"]), j(c["is_start"]),
            j(c["is_end"]), j(c["qm"]), j(c["ql"]), j(c["nr"]), j(cw),
            j(subst), params, max_insert=None if max_ins is None else j(max_ins))
    else:
        out = ak.poa_dp_batch(
            j(c["pos"]), j(c["mask"]), j(c["weight"]), j(c["preds"]),
            j(c["is_start"]), j(c["is_end"]), j(c["qm"]), j(c["ql"]),
            j(c["nr"]), j(cw), params,
            max_insert=None if max_ins is None else j(max_ins), window=32)
    return [np.asarray(a) for a in out]


def _assert_same(got, want, what: str, raw_rtol: float = 0.0):
    for name, a, b in zip(("emit", "best_j", "best_i"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
    if raw_rtol:
        np.testing.assert_allclose(got[3], want[3], rtol=raw_rtol, err_msg=f"{what}: raw")
    else:
        np.testing.assert_array_equal(got[3], want[3], err_msg=f"{what}: raw")


@pytest.fixture(scope="module")
def bucket():
    return _bucket(8)


@pytest.mark.parametrize("mode", MODES)
def test_plain_graph_dp_matches_pallas_and_xla(bucket, mode):
    cw, max_ins, subst = _mode_inputs(bucket, mode, 3)
    p = DpParams()
    jp = JaxDpParams()
    got = _port(bucket, cw, max_ins, subst, p)
    assert (got[0] >= 0).sum() > 0.8 * bucket["ql"].sum()
    _assert_same(got, _pallas(bucket, cw, max_ins, subst, jp), f"{mode} vs pallas")
    _assert_same(got, _xla(bucket, cw, max_ins, subst, jp), f"{mode} vs xla",
                 raw_rtol=1e-6 if mode == "matrix" else 0.0)


def test_forbid_and_matrix_together_match_xla(bucket):
    """--use-subst-matrix --insertion forbid: both switches in one DP,
    against the XLA oracle poa_dp_subst_batch(max_insert=...)."""
    cw, _, subst = _mode_inputs(bucket, "matrix", 4)
    got = _port(bucket, cw, bucket["max_insert"], subst, DpParams())
    _assert_same(got, _xla(bucket, cw, bucket["max_insert"], subst, JaxDpParams()),
                 "forbid+matrix vs xla", raw_rtol=1e-6)


def test_inexact_params_match_pallas(bucket):
    """Scheme constants f32 cannot hold round from their doubles, as the
    Pallas kernel's static floats do."""
    cw, _, _ = _mode_inputs(bucket, "weighted", 5)
    vals = dict(match=-2.3, mismatch=1.1, gap_open=5.3, gap_ext=2.1)
    got = _port(bucket, cw, None, None, DpParams(**vals))
    _assert_same(got, _pallas(bucket, cw, None, None, JaxDpParams(**vals)),
                 "inexact vs pallas")


def test_ring_depth_does_not_change_the_result(bucket):
    cw, _, _ = _mode_inputs(bucket, "weighted", 6)
    t = torch.from_numpy
    mask_u8, predbits, flags = gk.pack_graph_host(
        bucket["mask"], bucket["preds"], bucket["is_start"], bucket["is_end"], bucket["nr"])
    args = (t(bucket["pos"]), t(mask_u8), t(bucket["weight"]), t(predbits), t(flags),
            t(bucket["qm"].astype(np.uint8)), t(bucket["ql"]), t(cw))
    k = gk.pick_k_ring(bucket["maxd"])
    assert k > bucket["maxd"] and k < 32
    small = gk.graph_dp_plain(*args, params=DpParams(), k_ring=k)
    full = gk.graph_dp_plain(*args, params=DpParams(), k_ring=32)
    for a, b in zip(small, full):
        assert torch.equal(a, b)


def test_pack_graph_host_native_matches_numpy_and_reference(bucket):
    c = bucket
    got = gk.pack_graph_host(c["mask"], c["preds"], c["is_start"], c["is_end"], c["nr"])
    plain = (c["mask"].astype(np.uint8),
             *gk._pack_graph_numpy(c["mask"], c["preds"], c["is_start"], c["is_end"], c["nr"]))
    ref = jax_pack_graph_host(c["mask"], c["preds"], c["is_start"], c["is_end"], c["nr"])
    for a, b, r in zip(got, plain, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r)
    assert got[1].dtype == np.int32 and got[2].dtype == np.uint8


@pytest.mark.parametrize("maxd,k", [(0, 2), (1, 2), (2, 4), (8, 16), (10, 16), (31, 32), (32, 0)])
def test_pick_k_ring(maxd, k):
    assert gk.pick_k_ring(maxd) == k
