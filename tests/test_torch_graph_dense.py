"""The graph engine's dense-predecessor route against the JAX package.

A bucket whose largest predecessor distance is 32 or more cannot use
the graph kernel (its backpointers hold 5-bit distances); the reference
runs it through the XLA dense core on every backend, and so does the
port (align_kernel.graph_dp_dense + graph_traceback_dense: on the CPU
their plain versions poa_dp_dense + traceback_dense, on the card the
kernels of csrc/graph_dense.cu).  The fixture is a
family in which one member carries a 40-base insertion that the
others skip, so the next column's nodes sit more than 40 topological
positions after their predecessors.  emit, best_j, best_i and raw must
equal ak.poa_dp_batch(window=None) and ak.poa_dp_subst_batch exactly.

The fixture and run_dense import nothing of JAX or the JAX package
(the fixture comes from the port's testing and ops/graph, which build
the JAX package's arrays from the same seed):
tests/test_torch_cuda.py runs the same cases on the card.
"""

import numpy as np
import pytest
import torch

from sina_tpu_torch import testing
from sina_tpu_torch.ops import align_kernel as tak
from sina_tpu_torch.ops import graph_kernel as gk
from sina_tpu_torch.ops.align_kernel import DpParams
from sina_tpu_torch.ops.graph import build_graph, pad_graph
from sina_tpu_torch.sequence import Sequence

INS = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small tensor operations: under
    the test run's parallel workers, torch's intra-op threads would
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_insertion(fam: list[Sequence], rng) -> list[Sequence]:
    """The family with INS empty columns opened after the middle of the
    alignment; member 0 fills them with random bases."""
    width = fam[0].width
    c0 = width // 2
    out = []
    for k, s in enumerate(fam):
        pos = s.positions.astype(np.int64)
        pos = np.where(pos >= c0, pos + INS, pos)
        masks = s.masks.copy()
        if k == 0:
            at = np.searchsorted(pos, c0)
            pos = np.insert(pos, at, np.arange(c0, c0 + INS))
            masks = np.insert(masks, at, (1 << rng.integers(0, 4, INS)).astype(np.uint8))
        out.append(Sequence(s.name, pos.astype(np.uint32), masks, width + INS, {}))
    return out


def dense_bucket() -> dict:
    """Three family graphs of 8 references, one member of each with a
    40-base insertion, and three queries, as numpy planes."""
    rng = np.random.default_rng(5)
    db = testing.make_reference(n_seqs=40, n_core=200, width=350, seed=21)
    graphs, nr, qs = [], [], []
    for i in range(3):
        g = build_graph(_with_insertion(db.sequences[3 * i : 3 * i + 8], rng))
        graphs.append(g)
        nr.append(g.n_nodes)
        qs.append(testing.unaligned_copy(
            testing.make_queries(db, n=1, seed=300 + i, branch_len=0.6)[0]))
    npad = max(nr) + 8
    mpad = max(len(q.masks) for q in qs) + 5
    graphs = [pad_graph(g, npad) for g in graphs]
    qm = np.zeros((3, mpad), np.int32)
    ql = np.zeros(3, np.int32)
    for b, q in enumerate(qs):
        qm[b, : len(q.masks)] = q.masks
        ql[b] = len(q.masks)
    preds = np.stack([g.preds for g in graphs])
    d = np.arange(npad)[None, :, None] - preds
    maxd = int(d[preds >= 0].max())
    assert maxd >= INS and gk.pick_k_ring(maxd) == 0
    return dict(
        pos=np.stack([g.pos for g in graphs]),
        mask=np.stack([g.mask.astype(np.int32) for g in graphs]),
        weight=np.stack([g.weight for g in graphs]),
        preds=preds,
        is_start=np.stack([g.is_start for g in graphs]),
        is_end=np.stack([g.is_end for g in graphs]),
        qm=qm, ql=ql, nr=np.asarray(nr, np.int32),
        max_insert=np.stack([np.clip(g.max_insert, 0, 10**6) for g in graphs]).astype(np.int32),
        width=graphs[0].width + 2, maxd=maxd,
    )


CASES = {
    "simple": dict(weights=False, forbid=False, subst=False),
    "weighted": dict(weights=True, forbid=False, subst=False),
    "forbid": dict(weights=False, forbid=True, subst=False),
    "subst": dict(weights=False, forbid=False, subst=True),
    "subst_forbid": dict(weights=True, forbid=True, subst=True),
}


def case_inputs(c: dict, case: str):
    """The case's column weights, insertion budgets (or None) and
    substitution matrices (or None)."""
    opt = CASES[case]
    rng = np.random.RandomState(7)
    cw = (rng.uniform(0.5, 2.0, (3, c["width"])) if opt["weights"]
          else np.ones((3, c["width"]))).astype(np.float32)
    max_ins = c["max_insert"] if opt["forbid"] else None
    subst = rng.uniform(-2, 2, (3, 4, 4)).astype(np.float32) if opt["subst"] else None
    return cw, max_ins, subst


def run_dense(c: dict, case: str, device) -> tuple[torch.Tensor, ...]:
    """The dense route on `device` through its dispatching functions
    (the plain versions on the CPU, the kernels on the card): (bp,
    best_j, best_i, raw, emit, done) as CPU tensors."""
    cw, max_ins, subst = case_inputs(c, case)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    preds = t(c["preds"], np.int32)
    bp, bj, bi, raw = tak.graph_dp_dense(
        t(c["pos"], np.int32), t(c["mask"], np.uint8), t(c["weight"], np.float32), preds,
        t(c["is_start"]), t(c["is_end"]), t(c["qm"], np.uint8), t(c["ql"]),
        t(c["nr"]), t(cw), DpParams(),
        max_insert=None if max_ins is None else t(max_ins),
        subst=None if subst is None else t(subst), maxd=c["maxd"])
    emit, done = tak.graph_traceback_dense(bp, bj, bi, preds, t(c["is_start"]))
    return tuple(x.cpu() for x in (bp, bj, bi, raw, emit, done))


@pytest.fixture(scope="module")
def bucket():
    return dense_bucket()


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_route_matches_xla(bucket, case):
    import jax.numpy as jnp

    from sina_tpu.ops import align_kernel as ak
    from sina_tpu.ops.align_kernel import DpParams as JaxDpParams

    c = bucket
    cw, max_ins, subst = case_inputs(c, case)
    j = jnp.asarray
    jmi = None if max_ins is None else j(max_ins)
    if subst is None:
        want = ak.poa_dp_batch(
            j(c["pos"]), j(c["mask"]), j(c["weight"]), j(c["preds"]),
            j(c["is_start"]), j(c["is_end"]), j(c["qm"]), j(c["ql"]),
            j(c["nr"]), j(cw), JaxDpParams(), max_insert=jmi, window=None)
    else:
        want = ak.poa_dp_subst_batch(
            j(c["pos"]), j(c["mask"]), j(c["preds"]), j(c["is_start"]),
            j(c["is_end"]), j(c["qm"]), j(c["ql"]), j(c["nr"]), j(cw),
            j(subst), JaxDpParams(), max_insert=jmi)
    _, bj, bi, raw, emit, done = run_dense(c, case, "cpu")
    assert done.tolist() == [1, 1, 1]
    got = (emit.numpy(), bj.numpy(), bi.numpy(), raw.numpy())
    for name, a, b in zip(("emit", "best_j", "best_i", "raw"), got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert (got[0] >= 0).sum() > 0.8 * c["ql"].sum()


# The dense kernel's node records (ops/align_kernel.dense_node_table):
# the flags and the window divisor it reads, computed on the host from
# the planes; here against the plain version's rules and numpy.

TABLE_MODES = ("simple", "forbid", "subst_forbid")
REPEAT, DEEP = 8 << 8, 16 << 8  # the record's flag bits in its mask word


def _torch_inputs(c: dict, case: str) -> tuple[list, dict]:
    """The dense route's operands of dense_node_table, as CPU tensors,
    and its keywords (max_insert, subst)."""
    cw, max_ins, subst = case_inputs(c, case)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))

    args = [t(c["pos"], np.int32), t(c["mask"], np.uint8), t(c["weight"], np.float32),
            t(c["preds"], np.int32), t(c["is_start"]), t(c["is_end"]), t(c["nr"]), t(cw)]
    return args, dict(max_insert=None if max_ins is None else t(max_ins),
                      subst=None if subst is None else t(subst))


def _with_twin_start_nodes(c: dict) -> dict:
    """The bucket with nodes 5 and 6 of query 1 made two real start
    nodes without predecessors and with equal records (no node names
    them as a predecessor any more): a repeat in the middle of a graph,
    not padding."""
    c = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in c.items()}
    for key in ("pos", "mask", "weight", "max_insert"):
        c[key][1, 6] = c[key][1, 5]
    c["is_start"][1, 5:7] = True
    c["is_end"][1, 5:7] = False
    c["preds"][1, 5:7] = -1
    c["preds"][1][np.isin(c["preds"][1], [5, 6])] = -1
    return c


def _plain_repeats(args: list, kw: dict, b: slice) -> list[bool]:
    """_repeats_previous over the planes poa_dp_dense compares, for the
    queries `b`."""
    pos, mask, weight, preds, is_start, is_end, nr, cw = (a[b] for a in args)
    costs = tak.node_costs(pos, weight, cw, None if kw["subst"] is None else kw["subst"][b],
                           DpParams())
    N = pos.shape[1]
    valid = torch.arange(N)[None, :] < nr.long()[:, None]
    planes = [costs[k] for k in ("subw", "dgo", "dge", "gio", "gie")]
    planes += [mask.long(), is_start.bool(), is_end.bool() & valid, valid]
    if kw["max_insert"] is not None:
        planes.append(kw["max_insert"][b])
    return tak._repeats_previous(planes, (preds.long() < 0).all(dim=2))


@pytest.mark.parametrize("twin", [False, True])
@pytest.mark.parametrize("case", TABLE_MODES)
def test_dense_node_table_repeat_flag_is_the_plain_rule(bucket, case, twin):
    """Each query's repeat flags are _repeats_previous's rule applied to
    that query alone (its padding nodes after the first; with `twin`
    also a real start node repeating its twin), and a node repeats in
    every query exactly where the plain version copies it for the whole
    batch.  The queries' graphs have different real node counts."""
    c = _with_twin_start_nodes(bucket) if twin else bucket
    args, kw = _torch_inputs(c, case)
    tab = tak.dense_node_table(*args, DpParams(), **kw, M=c["qm"].shape[1])
    rep = (tab[:, :, 5] & REPEAT) != 0
    B = rep.shape[0]
    assert len(set(c["nr"].tolist())) == B
    for b in range(B):
        assert rep[b].tolist() == _plain_repeats(args, kw, slice(b, b + 1)), b
        assert int(rep[b].sum()) >= c["pos"].shape[1] - int(c["nr"][b]) - 1
    assert rep.all(dim=0).tolist() == _plain_repeats(args, kw, slice(None))
    assert bool(rep[1, 6]) == twin


@pytest.mark.parametrize("depth", [1, 2, 15, 16, 17, "maxd-1", "maxd"])
def test_dense_node_table_deep_flag(bucket, depth):
    """The deep flag marks exactly the nodes some successor names from
    more than chip_depth nodes back (numpy over the slots), and no node
    without chip_depth."""
    c = bucket
    depth = c["maxd"] + (-1 if depth == "maxd-1" else 0) if isinstance(depth, str) else depth
    args, kw = _torch_inputs(c, "simple")
    M = c["qm"].shape[1]
    tab = tak.dense_node_table(*args, DpParams(), **kw, M=M, chip_depth=depth)
    preds = c["preds"]
    B, N, _ = preds.shape
    want = np.zeros((B, N), bool)
    for b, q, s in zip(*np.nonzero(preds >= 0)):
        p = preds[b, q, s]
        if q - p > depth:
            want[b, p] = True
    got = (tab[:, :, 5] & DEEP).numpy() != 0
    np.testing.assert_array_equal(got, want)
    assert want.any() == (depth < c["maxd"])
    none = tak.dense_node_table(*args, DpParams(), **kw, M=M)
    assert not ((none[:, :, 5] & DEEP) != 0).any()


@pytest.mark.parametrize("M", [1536, 2048, 7])
def test_dense_node_table_window_divisor(bucket, M):
    """Forbid mode's per-node divisor is ceil(2**32 / R) for R =
    clip(budget, 1, M) >= 2 (0 for R = 1), so that n // R == (n * rdiv)
    >> 32 for every lane number n < 2**16; without budgets it is 0."""
    c = dict(bucket)
    c["max_insert"] = np.random.default_rng(M).choice(
        [-3, 0, 1, 2, 3, 5, 33, 129, M - 1, M, M + 9, 10**6], c["pos"].shape).astype(np.int32)
    args, kw = _torch_inputs(c, "forbid")
    tab = tak.dense_node_table(*args, DpParams(), **kw, M=M)
    rdiv = tab[:, :, 7].numpy().astype(np.int64) & 0xFFFFFFFF
    R = np.clip(c["max_insert"].astype(np.int64), 1, M)
    np.testing.assert_array_equal(rdiv, np.where(R > 1, -(-(1 << 32) // R), 0))
    n = np.arange(1 << 16, dtype=np.uint64)
    for r, d in set(zip(R.ravel().tolist(), rdiv.ravel().tolist())):
        if r > 1:
            np.testing.assert_array_equal((n * np.uint64(d)) >> np.uint64(32), n // np.uint64(r))
    args, kw = _torch_inputs(c, "simple")
    assert int(tak.dense_node_table(*args, DpParams(), **kw, M=M)[:, :, 7].abs().sum()) == 0
