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


def _kmer_ids(pattern: str, B: int, L: int, R: int, seed: int) -> torch.Tensor:
    """(B, L) int32 ids into an R-row matrix (the last row the sink):
    random, in ascending or descending order, one id repeated 600 or
    2,100 times among random ones, every id the sink row, or a third of
    the ids below 0 and a third past the end."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, R, (B, L))
    if pattern == "ascending":
        ids.sort(axis=1)
    elif pattern == "descending":
        ids = -np.sort(-ids, axis=1)
    elif pattern.startswith("repeat"):
        n = int(pattern[len("repeat"):])
        ids[:, 50:50 + n] = 7
    elif pattern == "sink":
        ids[:] = R - 1
    elif pattern == "outside":
        ids[:, ::3] = rng.integers(-5, 0, ids[:, ::3].shape)
        ids[:, 1::3] = rng.integers(R, R + 10, ids[:, 1::3].shape)
    return torch.from_numpy(ids.astype(np.int32))


# (B, L, Sb, R, pattern): B = 1; L = 1, 511, 513, 4,096 and 9,000 (three
# sort chunks); Sb = 4, 12, 16, 1,028 (4-byte loads) and 12,544 (16-byte);
# counts that flush the 8-bit lanes (L = 4,096 over 300 rows), more than
# 2,040 single runs (20,000 rows), a count past the lanes' reach (2,100 and
# 4,096) that goes straight to the wide counters
KMER_RUN_CASES = [
    (1, 1, 12_544, 300, "random"),
    (1, 511, 12_544, 300, "random"),
    (3, 513, 12_544, 300, "random"),
    (2, 4096, 1028, 300, "random"),
    (2, 4096, 12, 20_000, "random"),
    (2, 9000, 16, 20_000, "random"),
    (3, 700, 12_544, 300, "repeat600"),
    (2, 4096, 12_544, 300, "repeat2100"),
    (4, 512, 4, 300, "ascending"),
    (4, 512, 12, 300, "descending"),
    (2, 4096, 12_544, 300, "sink"),
    (3, 600, 1028, 300, "outside"),
    (2, 600, 12_544, 300, "outside"),
]


@pytest.mark.parametrize("B,L,Sb,R,pattern", KMER_RUN_CASES)
def test_kmer_kernel_runs_match_plain(cuda, B, L, Sb, R, pattern):
    """The run-list kernel's scores and group maxima equal the plain
    versions, with and without the group maxima; one launch a call;
    16-byte loads where Sb allows them."""
    g = torch.Generator().manual_seed(Sb + L + R)
    P = torch.randint(0, 256, (R, Sb), dtype=torch.uint8, generator=g)
    P[-1] = 0
    kmers = _kmer_ids(pattern, B, L, R, seed=B * L + Sb)
    want = kk.kmer_scores_plain(P, kmers)
    Pc, kc = P.to(cuda), kmers.to(cuda)
    before = kernels.launches["kmer_score"]
    scores, gmax = kk.kmer_scores(Pc, kc, gmax=True)
    assert kernels.launches["kmer_score"] == before + 1
    _equal([scores, gmax], [want, kk.group_max_plain(want)])
    _equal([kk.kmer_scores(Pc, kc)], [want])
    assert kernels.launches["kmer_score"] == before + 2
    assert kk.kmer_score_plan(Pc)["load_bytes"] == (16 if Sb % 16 == 0 else 4)


@pytest.mark.parametrize("offset,load_bytes", [(4, 4), (8, 4)])
def test_kmer_kernel_at_a_narrower_alignment(cuda, offset, load_bytes):
    """A matrix whose rows allow 16-byte loads but whose base is only 4-
    or 8-byte aligned takes 4-byte loads, with the same result."""
    g = torch.Generator().manual_seed(offset)
    P = torch.randint(0, 256, (300, 12_544), dtype=torch.uint8, generator=g)
    P[-1] = 0
    kmers = _kmer_ids("random", 3, 512, 300, seed=offset)
    raw = torch.empty(P.numel() + offset, dtype=torch.uint8, device=cuda)
    Pc = raw[offset:].view(P.shape)
    Pc.copy_(P)
    assert Pc.data_ptr() % 16 == offset % 16
    assert kk.kmer_score_plan(Pc)["load_bytes"] == load_bytes
    want = kk.kmer_scores_plain(P, kmers)
    _equal(kk.kmer_scores(Pc, kmers.to(cuda), gmax=True), [want, kk.group_max_plain(want)])


def test_kmer_kernel_tiled_view_with_gmax(cuda):
    g = torch.Generator().manual_seed(2)
    P3 = torch.randint(0, 256, (300, 32, 392), dtype=torch.uint8, generator=g)
    P3[-1] = 0
    kmers = _kmer_ids("random", 5, 700, 300, seed=2)
    want = kk.kmer_scores_plain(P3.reshape(300, -1), kmers)
    _equal(kk.kmer_scores(P3.to(cuda), kmers.to(cuda), gmax=True),
           [want, kk.group_max_plain(want)])


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


def test_grouped_topk_on_cuda_equals_cpu(cuda):
    """score_topk at 100,352 padded references (the grouped path) with
    the k-th value tied among thousands: the same values and ids on the
    card as on the CPU, at the search's k and famfinder's."""
    rng = np.random.default_rng(5)
    S, L = 100_352, 48
    c = rng.integers(0, 13, S)
    c[rng.choice(S, 8, replace=False)] = np.arange(40, 32, -1)
    bits = np.arange(L + 1)[:, None] < c[None, :]
    bits[-1] = False
    P = torch.from_numpy(np.packbits(bits, axis=1, bitorder="little"))
    kmers = np.tile(np.arange(L, dtype=np.int32), (4, 1))
    kmers[1, ::2] = L
    kmers[2] = rng.integers(0, L + 1, L)
    kmers = torch.from_numpy(kmers)
    for k in (1000, 256, 8):
        before = kernels.launches["kmer_score"]
        got = kk.score_topk(P.to(cuda), kmers.to(cuda), k)
        # one launch: the scores and the group maxima of the first stage
        assert kernels.launches["kmer_score"] == before + 1
        _equal([got], [kk.score_topk(P, kmers, k)])


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


@pytest.mark.parametrize(
    "B,C,M,lanes",
    [(3, 1, 64, 4), (2, 513, 132, 4), (4, 300, 1536, 4), (2, 257, 2052, 8),
     (2, 1, 4096, 8), (2, 257, 4100, 16), (2, 1, 6000, 16)],
)
def test_profile_dp_lanes_and_staging(cuda, B, C, M, lanes):
    """C = 1, C not a multiple of the kernel's 256-column staging chunk,
    and the 4, 8 and 16 lanes-a-thread instantiations, which the kernel
    takes by M (4 up to 2048, 8 up to 4096, 16 above)."""
    fgq, qmask, lens = _profiles(B * C + M + lanes, B, C, M)
    params = DpParams()
    got = pk.profile_dp(fgq.to(cuda), qmask.to(cuda), lens.to(cuda), params)
    _equal(got, pk.profile_dp_plain(fgq, qmask, lens, params))
    assert pk.profile_dp_plan(M)["lanes"] == lanes


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


def _lanes(M):
    """The kernel's lanes a thread at M (csrc/profile_dp.cu lanes_for)."""
    K = 4
    while K < 16 and M > K * 512:
        K *= 2
    return K


def _budgets(seed, B, C, M):
    """(B, C) int32 insertion budgets for the forbid mode: row 0 all 0,
    row 1 all 1, row 2 small (0-3), row 3 above M, row 4 cycling column
    by column through every class edge of the kernel's lane geometry
    (below 1, 1, K and K + 1 lanes a thread, 32 K - 1, 32 K and 32 K + 1
    around one warp's lanes, M - 1, M, above M), the rest a mix of 0,
    1, small, mid-size, those edges, above M and 10**6."""
    rng = np.random.default_rng(seed)
    K = _lanes(M)
    edges = [0, 1, K, K + 1, 32 * K - 1, 32 * K, 32 * K + 1, M - 1, M, M + 3]
    choices = np.array([0, 0, 1, 2, 3, 5, 9, 17, 33, 100, *edges, 10**6])
    bud = choices[rng.integers(0, len(choices), (B, C))]
    for b, row in enumerate((np.zeros(C), np.ones(C), rng.integers(0, 4, C),
                             M + 1 + rng.integers(0, 50, C),
                             np.resize(edges, C))[:B]):
        bud[b] = row
    return torch.from_numpy(bud.astype(np.int32))


@pytest.mark.parametrize(
    "B,C,M",
    [(1, 1, 4), (4, 17, 8), (9, 96, 132), (5, 300, 1536), (3, 257, 2052), (2, 40, 4100),
     (2, 20, 8200), (1, 5, 16384),
     # a ragged last warp at 4, 8 and 16 lanes a thread: one thread of
     # 13 warps, one and a half of 10, one and a quarter of 9
     (6, 260, 1540), (5, 70, 2316), (5, 30, 4116)],
)
def test_profile_dp_forbid_matches_plain(cuda, B, C, M):
    """The bounded-insertion mode at the thread-count edges, the 4, 8
    and 16 lanes-a-thread instantiations (with a ragged last warp), C
    past the 256-column staging chunk, M up to the kernel's limit and
    budgets at the edges of its window classes: bp, best_c, best_i, raw
    and the chain traceback's emit exact; counted as profile_dp_forbid."""
    fgq, qmask, lens = _profiles(B * C + M + 1, B, C, M)
    budget = _budgets(B + C + M, B, C, M)
    params = DpParams()
    before = dict(kernels.launches)
    got = pk.profile_dp(fgq.to(cuda), qmask.to(cuda), lens.to(cuda), params,
                        budget=budget.to(cuda))
    assert kernels.launches["profile_dp_forbid"] == before["profile_dp_forbid"] + 1
    assert kernels.launches["profile_dp"] == before["profile_dp"]
    want = pk.profile_dp_plain(fgq, qmask, lens, params, budget=budget)
    _equal(got, want)
    _equal([pk.chain_traceback(*got[:3])], [pk.chain_traceback_plain(*want[:3])])
    plan = pk.profile_dp_plan(M, forbid=True)
    assert plan["dyn_smem"] >= 4 * M and pk.profile_dp_plan(M)["dyn_smem"] == 0


def test_profile_dp_forbid_fam_idx_gather(cuda):
    """Rows share profiles through fam_idx while each keeps its own
    budgets; constants that f32 cannot hold."""
    fgq, qmask, lens = _profiles(9, 8, 64, 64)
    fam = torch.tensor([3, 0, 3, 1, 2, 0, 1, 3], dtype=torch.int32)
    budget = _budgets(10, 8, 64, 64)
    params = DpParams(-2.3, 1.1, 5.3, 2.1)
    u = fgq[:4].contiguous()
    got = pk.profile_dp(u.to(cuda), qmask.to(cuda), lens.to(cuda), params, fam.to(cuda),
                        budget.to(cuda))
    _equal(got, pk.profile_dp_plain(u, qmask, lens, params, fam, budget))


def test_profile_dp_forbid_rejects_bad_budget(cuda):
    fgq, qmask, lens = _profiles(2, 3, 16, 8)
    args = [a.to(cuda) for a in (fgq, qmask, lens)]
    budget = _budgets(3, 3, 16, 8)
    with pytest.raises(TypeError, match="budget"):
        pk.profile_dp(*args, DpParams(), budget=budget.long().to(cuda))
    with pytest.raises(ValueError, match="budget"):
        pk.profile_dp(*args, DpParams(), budget=budget[:, :8].contiguous().to(cuda))
    with pytest.raises(ValueError, match="budget"):
        pk.profile_dp(*args, DpParams(), budget=budget.to(cuda).t().contiguous().t())
    with pytest.raises(ValueError, match="budget"):
        pk.profile_dp(*args, DpParams(), budget=budget)


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


@pytest.mark.parametrize("M", [1536, 2048])
@pytest.mark.parametrize("mode", ["simple", "forbid"])
def test_graph_dp_ring_at_the_shared_memory_limit(cuda, mode, M):
    """The deepest ring that fits shared memory (the shared-ring route)
    and one slot deeper (the global-ring route, counted in
    kernels.launches["graph_dp_global_ring"]), at the main path's M
    buckets, in simple and forbid mode: both equal the plain version."""
    from sina_tpu_torch.ops import graph_kernel as gk

    ops, budget, width, k = _graph_bucket(M + 7, 2, 3, M)
    max_ins = budget if mode == "forbid" else None
    args = [*ops.values(), torch.ones((2, width)), max_ins]
    kmax = gk.graph_dp_plan(M, k, mode == "forbid")["max_shared_ring"]
    assert k <= kmax < 32
    for depth, shared in ((kmax, True), (kmax + 1, False)):
        plan = gk.graph_dp_plan(M, depth, mode == "forbid")
        assert bool(plan["shared_ring"]) == shared
        slot = (2 * plan["lanes"] + 1) * plan["threads"]  # V, D and V left of each thread
        assert plan["scratch"] == (0 if shared else depth * slot)
        before = dict(kernels.launches)
        got = gk.graph_dp(*[a.to(cuda) if a is not None else None for a in args],
                          params=DpParams(), k_ring=depth)
        assert kernels.launches["graph_dp"] == before["graph_dp"] + 1
        assert (kernels.launches["graph_dp_global_ring"]
                == before["graph_dp_global_ring"] + (0 if shared else 1))
        _equal(got, gk.graph_dp_plain(*args, params=DpParams(), k_ring=depth))


@pytest.mark.parametrize("lanes,M", [(4, 1536), (8, 3000), (16, 5008), (32, 8200)])
@pytest.mark.parametrize("mode", ["simple", "forbid_matrix"])
def test_graph_dp_lanes_match_plain(cuda, mode, lanes, M):
    """The 4, 8, 16 and 32 lanes-a-thread instantiations, which the
    kernel takes by M (4 up to 2048, doubling with each doubling of M):
    the main path's bucket and one M past each step."""
    from sina_tpu_torch.ops import graph_kernel as gk

    ops, budget, width, k = _graph_bucket(lanes, 2, 9, M)
    rng = np.random.default_rng(lanes)
    cw = torch.from_numpy(rng.uniform(0.5, 2.0, (2, width)).astype(np.float32))
    extra = [None, None]
    if mode == "forbid_matrix":
        extra = [budget, torch.from_numpy(rng.uniform(-2, 2, (2, 4, 4)).astype(np.float32))]
    args = [*ops.values(), cw, *extra]
    got = gk.graph_dp(*[a.to(cuda) if a is not None else None for a in args],
                      params=DpParams(), k_ring=k)
    _equal(got, gk.graph_dp_plain(*args, params=DpParams(), k_ring=k))
    assert gk.graph_dp_plan(M, k, "forbid" in mode)["lanes"] == lanes


def test_graph_dp_rejects_bad_operands(cuda):
    from sina_tpu_torch.ops import graph_kernel as gk

    ops, _, width, k = _graph_bucket(4, 1, 0, 64)
    args = [a.to(cuda) for a in ops.values()] + [torch.ones((1, width), device=cuda)]
    with pytest.raises(ValueError, match="k_ring"):
        gk.graph_dp(*args, params=DpParams(), k_ring=33)
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


# (B, C, M): one query at sizes below one window, not multiples of it
# (M % 4 != 0: byte copies); M % 16 != 0 (4-byte copies); the window
# crossed in both directions, with 4-byte and with 16-byte copies
CHAIN_SHAPES = [(1, 13, 7), (3, 100, 36), (4, 700, 600), (2, 700, 640)]
# (B, N, M): odd M (one-cell copies), even M (4-byte), M % 8 == 0 (16-byte)
GRAPH_SHAPES = [(1, 13, 7), (3, 100, 37), (4, 700, 500), (2, 600, 512)]


def _copy_bytes(M, elem):
    return 16 if M * elem % 16 == 0 else 4 if M * elem % 4 == 0 else elem


def _on(cuda, *arrays, offset=0):
    """numpy arrays as CUDA tensors; `offset` bytes into a buffer for
    the first (a plane whose lines are less aligned than its shape
    allows)."""
    out = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays]
    if offset:
        p = out[0]
        raw = torch.empty(p.numel() * p.element_size() + offset, dtype=torch.uint8,
                          device=cuda)
        view = raw[offset:].view(p.dtype).view(p.shape)
        view.copy_(p)
        out[0] = view
    return out


@pytest.mark.parametrize("shape", CHAIN_SHAPES)
@pytest.mark.parametrize("case", ["random", "deletion_run", "insertion_run", "edge_starts",
                                  "outside_starts", "step_cap"])
def test_chain_traceback_on_adversarial_planes(cuda, case, shape):
    """The staged-window kernel equals the plain walk on every case of
    sina_tpu_torch.testing.chain_traceback_case, at odd shapes and across
    windows."""
    from sina_tpu_torch import testing

    bp, bc, bi = testing.chain_traceback_case(case, 17, *shape)
    t = _on(cuda, bp, bc, bi)
    before = kernels.launches["chain_traceback"]
    emit = pk.chain_traceback(*t)
    assert kernels.launches["chain_traceback"] == before + 1
    _equal([emit], [pk.chain_traceback_plain(*t)])
    assert pk.chain_traceback_plan(t[0])["copy_bytes"] == _copy_bytes(shape[2], 1)


@pytest.mark.parametrize("shape", GRAPH_SHAPES)
@pytest.mark.parametrize("case", ["random", "deletion_run", "insertion_run", "edge_starts",
                                  "outside_starts", "step_cap", "jumps", "zero_dist"])
def test_graph_traceback_on_adversarial_planes(cuda, case, shape):
    """The staged-window kernel equals the plain walk (emit and done) on
    every case of sina_tpu_torch.testing.graph_traceback_case, at odd
    shapes and across windows; step_cap's walks do not finish."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.ops import graph_kernel as gk

    t = _on(cuda, *testing.graph_traceback_case(case, 19, *shape))
    before = kernels.launches["graph_traceback"]
    emit, done = gk.graph_traceback(*t)
    assert kernels.launches["graph_traceback"] == before + 1
    _equal([emit, done], gk.graph_traceback_plain(*t))
    assert done.cpu().tolist() == [0 if case == "step_cap" else 1] * shape[0]
    assert gk.graph_traceback_plan(t[0])["copy_bytes"] == _copy_bytes(shape[2], 2)


@pytest.mark.parametrize("graph", [False, True])
def test_traceback_plane_at_a_narrower_alignment(cuda, graph):
    """A plane whose shape allows 16-byte copies but whose address does
    not (4 or 2 bytes into a buffer) takes the narrower copies, with the
    same result."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.ops import graph_kernel as gk

    if graph:
        t = _on(cuda, *testing.graph_traceback_case("random", 23, 2, 600, 512), offset=2)
        assert gk.graph_traceback_plan(t[0])["copy_bytes"] == 2
        _equal(gk.graph_traceback(*t), gk.graph_traceback_plain(*t))
    else:
        t = _on(cuda, *testing.chain_traceback_case("random", 23, 2, 700, 640), offset=4)
        assert pk.chain_traceback_plan(t[0])["copy_bytes"] == 4
        _equal([pk.chain_traceback(*t)], [pk.chain_traceback_plain(*t)])


def _mesh_matrix(layout: str, rng):
    """A random incidence matrix of 300 rows (the last the sink) in one
    of the sharded layouts: tiled (300, 32, 512), flat packed
    (300, 16384) (32,768 or more references a shard: the grouped
    top-k), or dense int8 (300, 2048) {0, 1}."""
    shape = {"tiled": (300, 32, 512), "flat": (300, 16384), "dense": (300, 2048)}[layout]
    P = rng.integers(0, 2 if layout == "dense" else 256, shape)
    P = P.astype(np.int8 if layout == "dense" else np.uint8)
    P[-1] = 0
    return P


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("layout", ["tiled", "flat", "dense"])
def test_sharded_search_on_a_card_mesh_equals_the_cpu_mesh(cuda, layout, dp):
    """A mesh of the card named 4 times against the same (dp, mp) on the
    CPU (the plain versions): the same values and ids, one scorer launch
    a shard, and the raw scores in the whole matrix's order."""
    from sina_tpu_torch.parallel.sharding import (
        make_mesh, shard_index_matrix, sharded_scores, sharded_search,
    )

    rng = np.random.default_rng(dp * 10 + len(layout))
    P = _mesh_matrix(layout, rng)
    kmers = rng.integers(0, 300, (8, 64)).astype(np.int32)
    kmers[:, ::5] = 299
    gmesh, cmesh = make_mesh([cuda] * 4, dp=dp), make_mesh([torch.device("cpu")] * 4, dp=dp)
    Pg, Pc = shard_index_matrix(gmesh, P), shard_index_matrix(cmesh, P)
    name = "kmer_score_dense" if layout == "dense" else "kmer_score"
    for k in (16, 300):
        before = kernels.launches[name]
        gv, gi = sharded_search(gmesh, k)(Pg, kmers)
        assert kernels.launches[name] == before + 4
        assert gv.device == cuda
        _equal([gv, gi], sharded_search(cmesh, k)(Pc, kmers))
    _equal([sharded_scores(gmesh, Pg, kmers)], [kk.kmer_scores(torch.from_numpy(P),
                                                             torch.from_numpy(kmers))])


def test_famfinder_on_a_card_mesh_equals_its_cpu_copy(cuda):
    """FamFinder on a (1, 4) mesh of the card: on_device("cpu") gives a
    (1, 4) mesh of the CPU, and both return the same candidates."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.famfinder import FamFinder, FamFinderConfig
    from sina_tpu_torch.parallel.sharding import make_mesh

    db = testing.make_reference(n_seqs=150, n_core=300, width=500, seed=21)
    qs = testing.make_queries(db, n=12, seed=4, branch_len=0.6)
    gf = FamFinder(db, FamFinderConfig(fs_min=10, fs_max=10, fs_full_len=300, fs_req_gaps=1),
                   cuda, mesh=make_mesh([cuda] * 4, dp=1))
    cf = gf.on_device("cpu")
    assert cf.mesh.shape == gf.mesh.shape and cf.mesh.devices[0][0] == torch.device("cpu")
    masks = [q.masks for q in qs]
    for a, b in zip(gf.score_topk(masks, 64), cf.score_topk(masks, 64)):
        np.testing.assert_array_equal(a, b)
