"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU: every test skips without one.  On the card (where
jax is not installed, so without tests/conftest.py):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Its fixtures come from the port's own testing and ops/graph: nothing
here imports jax or the JAX package.

The shapes are small edge cases; chip_smoke.py compares the kernels at
the main path's shapes.  All outputs are integers or f32 values
computed in the same operation order, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from sina_tpu_torch.ops import kernels
from sina_tpu_torch.ops import kmer_kernel as kk
from sina_tpu_torch.ops import profile_kernel as pk
from sina_tpu_torch.ops.align_kernel import DpParams
from sina_tpu_torch.ops.profile import _pack_fgq

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("B,L,Sb", [(1, 1, 4), (3, 37, 16), (16, 512, 1156), (5, 2000, 64)])
def test_kmer_kernel_matches_plain(cuda, B, L, Sb):
    g = torch.Generator().manual_seed(B * L + Sb)
    P = torch.randint(0, 256, (300, Sb), dtype=torch.uint8, generator=g)
    P[-1] = 0
    # ids past either end of the matrix clamp into it
    kmers = torch.randint(-5, 310, (B, L), dtype=torch.int32, generator=g)
    before = kernels.launches["kmer_score"]
    got = kk.kmer_scores(P.to(cuda), kmers.to(cuda))
    assert kernels.launches["kmer_score"] == before + 1
    _equal([got], [kk.kmer_scores_plain(P, kmers)])


def test_kmer_kernel_takes_tiled_view(cuda):
    g = torch.Generator().manual_seed(1)
    P3 = torch.randint(0, 256, (40, 32, 8), dtype=torch.uint8, generator=g)
    kmers = torch.randint(0, 40, (4, 64), dtype=torch.int32, generator=g)
    got = kk.kmer_scores(P3.to(cuda), kmers.to(cuda))
    _equal([got], [kk.kmer_scores_plain(P3.reshape(40, -1), kmers)])


def test_kmer_kernel_rejects_bad_operands(cuda):
    P = torch.zeros((10, 6), dtype=torch.uint8, device=cuda)
    k = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kk.kmer_scores(P, k)              # row bytes not a multiple of 4
    with pytest.raises(ValueError):
        kk.kmer_scores(torch.zeros((10, 8), dtype=torch.uint8, device=cuda), k.cpu())
    with pytest.raises(TypeError):
        kk.kmer_scores(torch.zeros((10, 8), dtype=torch.uint8, device=cuda), k.long())


@pytest.mark.parametrize(
    "B,L,S",
    [(1, 37, 256), (5, 1, 128), (3, 513, 384), (7, 64, 128), (4, 300, 16_384)],
)
def test_kmer_dense_kernel_matches_plain(cuda, B, L, S):
    """B = 1, L = 1, L = 513, S = 128 (one partial tile), S = 16,384;
    random int8 values of both signs, ids past either end clamped."""
    g = torch.Generator().manual_seed(B * L + S)
    P = torch.randint(-128, 128, (300, S), dtype=torch.int8, generator=g)
    P[-1] = 0
    kmers = torch.randint(-5, 310, (B, L), dtype=torch.int32, generator=g)
    before = kernels.launches["kmer_score_dense"]
    got = kk.kmer_scores(P.to(cuda), kmers.to(cuda))
    assert kernels.launches["kmer_score_dense"] == before + 1
    _equal([got], [kk.kmer_scores_dense_plain(P, kmers)])


def test_kmer_dense_kernel_all_sink(cuda):
    P = torch.randint(0, 2, (50, 256), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(3))
    P[-1] = 0
    kmers = torch.full((6, 90), 49, dtype=torch.int32)
    got = kk.kmer_scores(P.to(cuda), kmers.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (6, 256)
    assert int(got.abs().max()) == 0


def test_kmer_dense_kernel_rejects_bad_operands(cuda):
    k = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                 # row bytes not a multiple of 16
        kk.kmer_scores(torch.zeros((10, 120), dtype=torch.int8, device=cuda), k)
    flat = torch.zeros(10 * 128 + 1, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):                 # rows not 16-byte aligned
        kk.kmer_scores(flat[1:].view(10, 128), k)
    wide = torch.zeros((10, 256), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):                 # not contiguous
        kk.kmer_scores(wide[:, :128], k)
    with pytest.raises(TypeError):
        kk.kmer_scores(torch.zeros((10, 128), dtype=torch.int16, device=cuda), k)


def test_score_batch_on_a_dense_matrix_equals_the_packed_one(cuda):
    """FamFinder.score_batch with the int8 device_matrix(packed=False)
    (the dense kernel) and with the default packed one: equal scores."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.famfinder import FamFinder, FamFinderConfig
    from sina_tpu_torch.ops.kmer_index import device_matrix

    db = testing.make_reference(n_seqs=300, n_core=400, width=700, seed=6)
    packed = FamFinder(db, FamFinderConfig(fs_kmer_len=8), cuda)
    dense = packed.on_device(cuda)
    dense._P = device_matrix(dense.index, cuda, packed=False)
    assert dense._P.dtype == torch.int8
    masks = [q.masks for q in testing.make_queries(db, n=9, seed=2, branch_len=0.5)]
    before = dict(kernels.launches)
    a = dense.score_batch(masks)
    b = packed.score_batch(masks)
    assert kernels.launches["kmer_score_dense"] == before["kmer_score_dense"] + 1
    assert kernels.launches["kmer_score"] == before["kmer_score"] + 1
    np.testing.assert_array_equal(a, b)
    assert a.shape == (9, 300) and a.max() > 0


def test_topk_lowest_id_on_cuda(cuda):
    scores = torch.tensor([[3, 7, 7, 1, 7, 3, 0, 7]], dtype=torch.int32)
    vals, ids = kk.top_k_lowest_id(scores.to(cuda), 5)
    assert vals.cpu().tolist() == [[7, 7, 7, 7, 3]]
    assert ids.cpu().tolist() == [[1, 2, 4, 7, 0]]


def _profiles(seed, B, C, M):
    rng = np.random.default_rng(seed)
    cons = rng.integers(0, 4, (B, C))
    freqs = (rng.random((B, C, 4)) * 0.1).astype(np.float32)
    np.put_along_axis(freqs, cons[..., None], 0.85, axis=2)
    freqs *= rng.uniform(0.05, 1.0, (B, C, 1)).astype(np.float32)
    fgq = _pack_fgq(freqs, (rng.random((B, C)) * 0.4).astype(np.float32), DpParams())
    qmask = np.zeros((B, M), np.uint8)
    qlen = rng.integers(1, M + 1, B).astype(np.int32)
    cr = rng.integers(1, C + 1, B).astype(np.int32)
    for b in range(B):
        n = int(qlen[b])
        src = cons[b, np.sort(rng.choice(C, min(n, C), replace=False))]
        base = np.resize(src, n)
        qmask[b, :n] = (1 << base).astype(np.uint8)
        qmask[b, rng.random(M) < 0.03] |= 0b0101
        qmask[b, n:] = 0
    qlen[-1] = cr[-1] = 1          # a padding row
    lens = np.stack([qlen, cr], axis=1).astype(np.int32)
    return (torch.from_numpy(a) for a in (fgq, qmask, lens))


@pytest.mark.parametrize(
    "B,C,M", [(1, 1, 4), (3, 17, 8), (9, 96, 132), (4, 300, 4100), (2, 40, 8200)]
)
def test_profile_dp_and_traceback_match_plain(cuda, B, C, M):
    """Covers the kernel's thread-count edges and its K = 4, 8 and 16
    lanes-per-thread instantiations."""
    fgq, qmask, lens = _profiles(B * C + M, B, C, M)
    params = DpParams()
    got = pk.profile_dp(fgq.to(cuda), qmask.to(cuda), lens.to(cuda), params)
    want = pk.profile_dp_plain(fgq, qmask, lens, params)
    _equal(got, want)
    emit = pk.chain_traceback(*got[:3])
    _equal([emit], [pk.chain_traceback_plain(*want[:3])])


def test_profile_dp_fam_idx_gather(cuda):
    fgq, qmask, lens = _profiles(7, 8, 64, 64)
    fam = torch.tensor([3, 0, 3, 1, 2, 0, 1, 3], dtype=torch.int32)
    params = DpParams(-2.3, 1.1, 5.3, 2.1)
    u = fgq[:4].contiguous()
    got = pk.profile_dp(u.to(cuda), qmask.to(cuda), lens.to(cuda), params, fam.to(cuda))
    _equal(got, pk.profile_dp_plain(u, qmask, lens, params, fam))


def test_profile_dp_rejects_unsupported_m(cuda):
    fgq, qmask, lens = _profiles(1, 2, 8, 6)
    with pytest.raises(ValueError, match="M % 4"):
        pk.profile_dp(fgq.to(cuda), qmask.to(cuda), lens.to(cuda), DpParams())


def _graph_bucket(seed, B, extra_nodes, mpad):
    """B family graphs of 6 references, padded with `extra_nodes`
    padding nodes past the largest, and B queries in a (B, mpad)
    plane, as CPU tensors, plus the graphs' insertion budgets, the
    column-weight width and the ring depth."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.ops import graph_kernel as gk
    from sina_tpu_torch.ops.graph import build_graph, pad_graph

    db = testing.make_reference(n_seqs=30, n_core=120, width=220, seed=seed)
    graphs = [build_graph(db.sequences[2 * b : 2 * b + 6]) for b in range(B)]
    nr = np.asarray([g.n_nodes for g in graphs], np.int32)
    npad = int(nr.max()) + extra_nodes
    graphs = [pad_graph(g, npad) for g in graphs]
    qm = np.zeros((B, mpad), np.uint8)
    ql = np.zeros(B, np.int32)
    for b in range(B):
        q = testing.unaligned_copy(testing.make_queries(db, n=1, seed=seed + b, branch_len=0.6)[0])
        n = min(len(q.masks), mpad)
        qm[b, :n] = q.masks[:n]
        ql[b] = n
    preds = np.stack([g.preds for g in graphs])
    maxd = int((np.arange(npad)[None, :, None] - preds)[preds >= 0].max())
    mask_u8, predbits, flags = gk.pack_graph_host(
        np.stack([g.mask for g in graphs]), preds, np.stack([g.is_start for g in graphs]),
        np.stack([g.is_end for g in graphs]), nr)
    t = torch.from_numpy
    width = max(g.width for g in graphs) + 2
    ops = dict(
        pos=t(np.stack([g.pos for g in graphs]).astype(np.int32)), mask=t(mask_u8),
        weight=t(np.stack([g.weight for g in graphs]).astype(np.float32)),
        predbits=t(predbits), flags=t(flags), qmask=t(qm), qlen=t(ql),
    )
    budget = t(np.stack([np.clip(g.max_insert, 0, 10**6) for g in graphs]).astype(np.int32))
    return ops, budget, width, gk.pick_k_ring(maxd)


@pytest.mark.parametrize("mode", ["simple", "weighted", "forbid", "matrix", "forbid_matrix"])
@pytest.mark.parametrize("B,extra,M", [(1, 0, 233), (3, 37, 130), (2, 5, 2050)])
def test_graph_dp_and_traceback_match_plain(cuda, mode, B, extra, M):
    """Odd shapes: one query, padding nodes, M not a multiple of the
    lanes per thread (M = 2050 also takes the 8-lane instantiation),
    in each scoring mode."""
    from sina_tpu_torch.ops import graph_kernel as gk

    ops, budget, width, k = _graph_bucket(B * 100 + M, B, extra, M)
    rng = np.random.default_rng(B + M)
    cw = np.ones((B, width), np.float32)
    if mode != "simple":
        cw = rng.uniform(0.5, 2.0, (B, width)).astype(np.float32)
    max_ins = budget if "forbid" in mode else None
    subst = (torch.from_numpy(rng.uniform(-2, 2, (B, 4, 4)).astype(np.float32))
             if "matrix" in mode else None)
    args = [*ops.values(), torch.from_numpy(cw), max_ins, subst]
    params = DpParams(-2.3, 1.1, 5.3, 2.1) if mode == "weighted" else DpParams()
    before = dict(kernels.launches)
    got = gk.graph_dp(*[a.to(cuda) if a is not None else None for a in args],
                      params=params, k_ring=k)
    want = gk.graph_dp_plain(*args, params=params, k_ring=k)
    _equal(got, want)
    emit, done = gk.graph_traceback(got[0], got[1], got[2], ops["flags"].to(cuda))
    emit_p, done_p = gk.graph_traceback_plain(*want[:3], ops["flags"])
    _equal([emit, done], [emit_p, done_p])
    assert done.cpu().tolist() == [1] * B
    assert kernels.launches["graph_dp"] == before["graph_dp"] + 1
    assert kernels.launches["graph_traceback"] == before["graph_traceback"] + 1


def test_graph_dp_ring_depth_does_not_change_the_result(cuda):
    from sina_tpu_torch.ops import graph_kernel as gk

    ops, _, width, k = _graph_bucket(3, 2, 4, 300)
    args = [a.to(cuda) for a in ops.values()] + [torch.ones((2, width), device=cuda)]
    small = gk.graph_dp(*args, params=DpParams(), k_ring=k)
    full = gk.graph_dp(*args, params=DpParams(), k_ring=32)
    _equal(small, full)


def test_graph_dp_rejects_bad_operands(cuda):
    from sina_tpu_torch.ops import graph_kernel as gk

    ops, _, width, k = _graph_bucket(4, 1, 0, 64)
    args = [a.to(cuda) for a in ops.values()] + [torch.ones((1, width), device=cuda)]
    with pytest.raises(ValueError, match="k_ring"):
        gk.graph_dp(*args, params=DpParams(), k_ring=12)
    bad = list(args)
    bad[3] = bad[3].long()
    with pytest.raises(TypeError):
        gk.graph_dp(*bad, params=DpParams(), k_ring=k)


@pytest.mark.parametrize("case", ["forbid", "simple", "subst", "subst_forbid", "weighted"])
def test_graph_dense_route_matches_cpu(cuda, case):
    """The dense route (buckets with a predecessor 32 or more nodes
    back) on the card equals its CPU run, the backpointer plane
    included, on tests/test_torch_graph_dense.py's family with a
    40-base insertion."""
    from test_torch_graph_dense import CASES, dense_bucket, run_dense

    assert case in CASES
    c = dense_bucket()
    got = run_dense(c, case, cuda)
    want = run_dense(c, case, "cpu")
    _equal(got, want)
    assert got[5].tolist() == [1, 1, 1]
