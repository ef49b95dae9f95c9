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


# a 450k-reference index's row: 450,560 padded references, 56,320 bytes
SILVA_NR_SB = 56_320


@pytest.mark.parametrize("B", [1, 128, 1024])
@pytest.mark.parametrize("offset,load_bytes,tiles", [(0, 16, 28), (4, 4, 110)])
def test_kmer_kernel_at_the_silva_nr_width(cuda, B, offset, load_bytes, tiles):
    """The scorer with its group maxima at a 450k-reference index's row
    width (Sb = 56,320: 28 column tiles of 16-byte copies, or 110 of
    4-byte copies on a base 4 bytes off 16) at B = 1, famfinder's batch
    and the amplicon path's, on a matrix of 2,000 rows: each query 360
    ids and then the sink row, as famfinder pads them.  Exact against
    the plain versions, run on the card."""
    R, L = 2000, 512
    g = torch.Generator(device=cuda).manual_seed(B + offset)
    raw = torch.empty(R * SILVA_NR_SB + offset, dtype=torch.uint8, device=cuda)
    P = raw[offset:].view(R, SILVA_NR_SB)
    P.copy_(torch.randint(0, 256, (R, SILVA_NR_SB), dtype=torch.uint8, device=cuda,
                          generator=g))
    P[-1] = 0
    plan = kk.kmer_score_plan(P)
    assert (plan["load_bytes"], plan["tiles"]) == (load_bytes, tiles)
    kmers = _kmer_ids("random", B, L, R, seed=B + offset)
    kmers[:, 360:] = R - 1
    kc = kmers.to(cuda)
    want = kk.kmer_scores_plain(P, kc)
    before = kernels.launches["kmer_score"]
    _equal(kk.kmer_scores(P, kc, gmax=True), [want, kk.group_max_plain(want)])
    assert kernels.launches["kmer_score"] == before + 1


def _tied_silva_nr(rng, B: int = 4):
    """A packed matrix of 49 rows whose scores are set by construction
    over 450,560 references (score(s) = c_s: the query hits rows 0..47,
    reference s has bits in rows 0..c_s-1): eight distinct top scores,
    the rest 0-12 with heavy ties; queries as in
    test_grouped_topk_on_cuda_equals_cpu."""
    S, L = 8 * SILVA_NR_SB, 48
    c = rng.integers(0, 13, S)
    c[rng.choice(S, 8, replace=False)] = np.arange(40, 32, -1)
    bits = np.arange(L + 1)[:, None] < c[None, :]
    bits[-1] = False
    P = torch.from_numpy(np.packbits(bits, axis=1, bitorder="little"))
    kmers = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    kmers[1, ::2] = L
    kmers[2] = rng.integers(0, L + 1, L)
    return P, torch.from_numpy(kmers)


@pytest.mark.parametrize("k", [256, 1000])
def test_score_topk_on_cuda_equals_cpu_at_silva_nr_width(cuda, k):
    """score_topk over 450,560 padded references (the grouped top-k,
    famfinder's k and the search's) with the k-th value tied among
    tens of thousands: the same values and ids on the card as on the
    CPU, from one scorer launch."""
    P, kmers = _tied_silva_nr(np.random.default_rng(k))
    assert 8 * P.shape[1] == 450_560
    before = kernels.launches["kmer_score"]
    got = kk.score_topk(P.to(cuda), kmers.to(cuda), k)
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
    back) through its dispatching functions: on the card (the two
    kernels of csrc/graph_dense.cu, one launch each) it equals its CPU
    run (the plain versions), the backpointer plane included, on
    tests/test_torch_graph_dense.py's family with a 40-base insertion."""
    from test_torch_graph_dense import CASES, dense_bucket, run_dense

    assert case in CASES
    c = dense_bucket()
    before = dict(kernels.launches)
    got = run_dense(c, case, cuda)
    assert kernels.launches["graph_dp_dense"] == before["graph_dp_dense"] + 1
    assert kernels.launches["graph_traceback_dense"] == before["graph_traceback_dense"] + 1
    want = run_dense(c, case, "cpu")
    _equal(got, want)
    assert got[5].tolist() == [1, 1, 1]


def _random_dag(seed, B, N, M, P, *, full=False, nopred=0, far=False):
    """B random node-ordered graphs of N nodes (the last few padding
    nodes without predecessors) with up to P predecessor slots a node,
    left-packed with -1 pads, and B queries in a (B, M) plane, as numpy
    arrays of the dense route's types; with `full` every slot of a node
    past the P-th is a predecessor, with `nopred` every nopred-th node
    has none (and is not always a start node), with `far` the last real
    node's first predecessor is node 0 and every node is real, so the
    largest distance is N - 1.  Also the column-weight width, the largest distance and
    insertion budgets below 1, up to M and above it."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, 3 * N, (B, N)), axis=1).astype(np.int32)
    mask = (1 << rng.integers(0, 4, (B, N))).astype(np.uint8)
    mask[:, ::7] = rng.integers(1, 16, mask[:, ::7].shape)
    preds = np.full((B, N, P), -1, np.int32)
    nr = np.full(B, N, np.int32) if far else rng.integers(N - 6, N + 1, B).astype(np.int32)
    for b in range(B):
        for j in range(1, int(nr[b])):
            if nopred and j % nopred == 0:
                continue
            lo = max(0, j - 40)
            k = min(P, j - lo) if full else int(rng.integers(1, min(P, j - lo) + 1))
            preds[b, j, :k] = rng.choice(np.arange(lo, j), size=k, replace=False)
        if far:
            preds[b, nr[b] - 1, 0] = 0
    start = (preds[:, :, 0] < 0) & (rng.random((B, N)) < 0.5)
    start[:, 0] = True
    end = rng.random((B, N)) < 0.1
    end[np.arange(B), nr - 1] = True
    qm = (1 << rng.integers(0, 4, (B, M))).astype(np.uint8)
    qm[:, ::11] = rng.integers(1, 16, qm[:, ::11].shape)
    ql = rng.integers(M // 2, M + 1, B).astype(np.int32)
    ql[0] = M
    budget = rng.choice([-3, 0, 1, 2, 5, 17, M - 1, M, M + 7, 10**6], (B, N)).astype(np.int32)
    d = np.arange(N)[None, :, None] - preds
    maxd = int(d[preds >= 0].max())
    ops = dict(pos=pos, mask=mask, weight=rng.uniform(0.5, 2.0, (B, N)).astype(np.float32),
               preds=preds, is_start=start, is_end=end, qmask=qm, qlen=ql, n_real=nr)
    return ops, int(pos.max()) + 2, maxd, budget


# name: (B, N, M, P, options of _random_dag)
DENSE_SHAPES = {
    "one_query": (1, 60, 97, 4, {}),
    "ragged_lanes_8": (3, 50, 2050, 4, {}),
    "all_slots": (2, 70, 130, 8, {"full": True}),
    "no_predecessors": (2, 64, 77, 4, {"nopred": 3}),
    "ring_is_the_plane": (2, 40, 64, 4, {"far": True}),
    # M in 1537..2048: 4 lanes a thread in 512 threads, the block's
    # every warp slot in use (ragged last lane, then whole lanes)
    "full_block_4": (2, 50, 2047, 4, {}),
    "full_block_4_even": (1, 45, 2048, 4, {}),
}


@pytest.mark.parametrize("mode", ["simple", "forbid", "subst_forbid"])
@pytest.mark.parametrize("shape", sorted(DENSE_SHAPES))
def test_graph_dense_kernels_at_odd_shapes(cuda, shape, mode):
    """The dense DP and its walk against their plain versions on
    random graphs: one query, M not a multiple of the lanes a thread
    (and the 8-lane kernel), all eight slots valid, nodes without
    predecessors, the ring as deep as the plane (maxd = N - 1), forbid
    budgets below 1 and above M, weighted columns and a substitution
    matrix."""
    from sina_tpu_torch.ops import align_kernel as ak

    B, N, M, P, opt = DENSE_SHAPES[shape]
    ops, width, maxd, budget = _random_dag(N * M + P, B, N, M, P, **opt)
    if shape == "ring_is_the_plane":
        assert maxd == N - 1
    if shape.startswith("full_block_4"):
        plan = ak.graph_dp_dense_plan(M, "forbid" in mode, maxd, cuda)
        assert (plan["lanes"], plan["threads"]) == (4, 512)
    rng = np.random.default_rng(M)
    cw = (rng.uniform(0.5, 2.0, (B, width)) if mode != "simple"
          else np.ones((B, width))).astype(np.float32)
    extra = dict(max_insert=budget if "forbid" in mode else None,
                 subst=rng.uniform(-2, 2, (B, 4, 4)).astype(np.float32)
                 if "subst" in mode else None)
    t = torch.from_numpy
    cpu = [t(a) for a in ops.values()] + [t(cw)]
    cpu_x = {k: None if v is None else t(v) for k, v in extra.items()}
    params = DpParams(-2.3, 1.1, 5.3, 2.1) if mode == "simple" else DpParams()
    before = dict(kernels.launches)
    got = ak.graph_dp_dense(*[a.to(cuda) for a in cpu], params,
                            **{k: None if v is None else v.to(cuda) for k, v in cpu_x.items()},
                            maxd=maxd)
    want = ak.poa_dp_dense(*cpu, params, **cpu_x)
    _equal(got, want)
    emit, done = ak.graph_traceback_dense(*got[:3], cpu[3].to(cuda), cpu[4].to(cuda))
    _equal([emit, done], ak.traceback_dense(*want[:3], cpu[3], cpu[4]))
    assert kernels.launches["graph_dp_dense"] == before["graph_dp_dense"] + 1
    assert kernels.launches["graph_traceback_dense"] == before["graph_traceback_dense"] + 1


@pytest.mark.parametrize("seed", range(4))
def test_graph_traceback_dense_on_random_planes(cuda, seed):
    """The dense walk on planes of random cells (every code, slot and
    flag; slots reaching pads, which make some walks run into the step
    cap) equals traceback_dense, done flags included."""
    from sina_tpu_torch.ops import align_kernel as ak

    rng = np.random.default_rng(seed)
    B, N, M, P = 6, 45, 37, 4
    bp = torch.from_numpy(rng.integers(0, 1024, (B, N, M)).astype(np.int16))
    preds = np.full((B, N, P), -1, np.int32)
    for j in range(1, N):
        k = int(rng.integers(0, P + 1))
        preds[:, j, :k] = rng.integers(0, j, (B, k))
    preds = torch.from_numpy(preds)
    start = torch.from_numpy(rng.random((B, N)) < 0.05)
    bj = torch.from_numpy(rng.integers(0, N, B))
    bi = torch.from_numpy(rng.integers(0, M, B))
    want = ak.traceback_dense(bp, bj, bi, preds, start)
    got = ak.graph_traceback_dense(*(x.to(cuda) for x in (bp, bj, bi, preds, start)))
    _equal(got, want)
    assert 0 < int(want[1].sum()) < B  # some walks reach the step cap


def _dense_against_plain(cuda, ops, width, maxd, mode, budget, seed):
    """graph_dp_dense and graph_traceback_dense on the card against
    poa_dp_dense and traceback_dense on the CPU (one launch each), in
    `mode` (simple, forbid or subst_forbid, as the odd-shapes test)."""
    from sina_tpu_torch.ops import align_kernel as ak

    B = ops["pos"].shape[0]
    rng = np.random.default_rng(seed)
    cw = (rng.uniform(0.5, 2.0, (B, width)) if mode != "simple"
          else np.ones((B, width))).astype(np.float32)
    t = torch.from_numpy
    cpu = [t(a) for a in ops.values()] + [t(cw)]
    cpu_x = {"max_insert": t(budget) if "forbid" in mode else None,
             "subst": t(rng.uniform(-2, 2, (B, 4, 4)).astype(np.float32))
             if "subst" in mode else None}
    params = DpParams(-2.3, 1.1, 5.3, 2.1) if mode == "simple" else DpParams()
    before = dict(kernels.launches)
    got = ak.graph_dp_dense(*[a.to(cuda) for a in cpu], params,
                            **{k: None if v is None else v.to(cuda) for k, v in cpu_x.items()},
                            maxd=maxd)
    want = ak.poa_dp_dense(*cpu, params, **cpu_x)
    _equal(got, want)
    emit, done = ak.graph_traceback_dense(*got[:3], cpu[3].to(cuda), cpu[4].to(cuda))
    _equal([emit, done], ak.traceback_dense(*want[:3], cpu[3], cpu[4]))
    assert kernels.launches["graph_dp_dense"] == before["graph_dp_dense"] + 1
    assert kernels.launches["graph_traceback_dense"] == before["graph_traceback_dense"] + 1


def _pad_as_buckets_do(ops, budget, n_real):
    """Nodes n_real[b].. of each query made padding nodes as
    ops/graph.pad_graph makes them (no predecessors, the last column,
    mask and weight 0, neither start nor end), and no real node naming
    one: each query's first padding node follows a real node, the rest
    repeat it."""
    N = ops["pos"].shape[1]
    last = ops["pos"].max() + 1  # _random_dag's width - 1
    for b, n in enumerate(n_real):
        ops["pos"][b, n:] = last
        for key in ("mask", "weight", "is_start", "is_end"):
            ops[key][b, n:] = 0
        ops["preds"][b, n:] = -1
        ops["preds"][b][ops["preds"][b] >= n] = -1
        budget[b, n:] = 0
    ops["n_real"][:] = n_real
    ops["preds"].sort(axis=2)
    ops["preds"][:] = ops["preds"][:, :, ::-1]  # real slots first, as graphs pack them
    assert N == max(n_real)


@pytest.mark.parametrize("mode", ["simple", "forbid", "subst_forbid"])
def test_graph_dense_padding_differs_per_query(cuda, mode):
    """A bucket whose queries' graphs end at different nodes, one with no
    padding at all: the kernel copies each query's repeated padding
    nodes itself (the plain version copies a node only where every
    query repeats it), and bp, the end cells and the walks still equal
    the plain versions'.  Query 1 also holds two real start nodes
    without predecessors and with equal records, which repeat too."""
    B, N, M, P = 4, 90, 530, 4
    ops, width, _, budget = _random_dag(17, B, N, M, P)
    _pad_as_buckets_do(ops, budget, [N, N - 1, N - 23, N // 2])
    for key in ("pos", "mask", "weight"):
        ops[key][1, 21] = ops[key][1, 20]
    ops["is_start"][1, 20:22] = True
    ops["is_end"][1, 20:22] = False
    budget[1, 21] = budget[1, 20]
    ops["preds"][1, 20:22] = -1
    d = np.arange(N)[None, :, None] - ops["preds"]
    maxd = int(d[ops["preds"] >= 0].max())
    _dense_against_plain(cuda, ops, width, maxd, mode, budget, seed=3)


def _ring_edge_dag(seed, B, N, M, S):
    """_random_dag's graphs (every node's predecessors within 40 nodes)
    with predecessors at distances S - 1, S and S + 1 (the shared ring's
    last row and the first beyond it), three beyond it in one node (more
    than the kernel loads a node ahead), one from a repeated start node,
    a -1 slot before a real one, and node N - 1 naming node 0 (maxd = N -
    1); and budgets at the forbid window's edges at 4 lanes a thread
    (below 1, 1, 4 and 5 lanes, one warp's 128 lanes and one more, M - 1
    and M)."""
    ops, width, _, _ = _random_dag(seed, B, N, M, 8)
    pr = ops["preds"]
    ops["n_real"][:] = N
    pr[:, 50, :4] = [49, 50 - (S - 1), 50 - S, 50 - (S + 1)]
    pr[:, 60, :5] = [60 - (S + 3), 59, 60 - (S + 1), 60 - (S + 2), 58]
    # nodes 10 and 11: start nodes without predecessors and one record
    for key in ("pos", "mask", "weight"):
        ops[key][:, 11] = ops[key][:, 10]
    pr[:, 10:12] = -1
    pr[pr == 10] = -1
    ops["is_start"][:, 10:12] = True
    ops["is_end"][:, 10:12] = False
    pr[:, 12 + S, :3] = [-1, 11, 12 + S - 1]
    pr[:, N - 1, 0] = 0
    rng = np.random.default_rng(seed)
    budget = rng.choice([-1, 0, 1, 4, 5, 128, 129, M - 1, M], (B, N)).astype(np.int32)
    budget[:, 11] = budget[:, 10]
    return ops, width, budget


@pytest.mark.parametrize("M", [1536, 2048])
@pytest.mark.parametrize("mode", ["simple", "forbid"])
def test_graph_dense_at_the_ring_edges(cuda, mode, M):
    """Predecessors at the shared ring's edge (S - 1, S and S + 1 nodes
    back, S the plan's shared rows at this M and mode), several beyond it
    in one node, a repeated node's row read from beyond it, and maxd = N
    - 1, at the main path's widths: exact against the plain versions,
    with the scratch the plan asks for."""
    from sina_tpu_torch.ops import align_kernel as ak

    B, N = 2, 80
    plan = ak.graph_dp_dense_plan(M, mode == "forbid", N - 1, cuda)
    S = plan["shared_rows"]
    assert 2 <= S < 38 and plan["scratch_rows"] == N and plan["lanes"] == 4
    ops, width, budget = _ring_edge_dag(M + S, B, N, M, S)
    d = np.arange(N)[None, :, None] - ops["preds"]
    assert int(d[ops["preds"] >= 0].max()) == N - 1
    _dense_against_plain(cuda, ops, width, N - 1, mode, budget, seed=M)
    assert ak.graph_dp_dense_plan(M, mode == "forbid", S, cuda)["scratch_rows"] == 0


@pytest.mark.parametrize("M", [501, 502, 504])
def test_graph_traceback_dense_jumps_beyond_the_window(cuda, M):
    """The dense walk on random planes over graphs whose slots 0-5 name
    the 1-6 nodes before a node, slot 6 one 257-450 nodes back (beyond
    the 256-node window) and slot 7 none; the cells' slots are mostly 0,
    rarely 6, so the walks are long and some jump out of the window.
    From the plane's far corner, its last node, its first position and
    inner cells, with one-cell (M odd), 4-byte (M even) and 16-byte (M %
    8 == 0) window copies: emit and done equal traceback_dense."""
    from sina_tpu_torch.ops import align_kernel as ak

    rng = np.random.default_rng(M)
    B, N, P = 5, 700, 8
    shape = (B, N, M)
    prob = [0.9, 0.03, 0.03, 0.02, 0.01, 0.002, 0.005, 0.003]
    cells = (rng.choice([1, 1, 1, 1, 1, 1, 2, 3], shape)
             | (rng.choice(8, shape, p=prob) << 2) | (rng.choice(8, shape, p=prob) << 5))
    cells |= (rng.random(shape) < 0.3).astype(np.int64) << 8
    cells |= (rng.random(shape) < 0.3).astype(np.int64) << 9
    bp = torch.from_numpy(cells.astype(np.int16))
    j = np.arange(N)[None, :, None]
    preds = np.maximum(j - np.arange(1, 7)[None, None, :], 0).repeat(B, axis=0)
    far = np.maximum(j[..., 0] - rng.integers(257, 451, (B, N)), 0)
    preds = np.concatenate([preds, far[..., None], np.full((B, N, 1), -1)], axis=2)
    preds[:, 0] = -1
    preds = torch.from_numpy(preds.astype(np.int32))
    start = torch.from_numpy(rng.random((B, N)) < 0.0005)
    start[:, 0] = True
    bj = torch.tensor([N - 1, N - 1, N - 1, 300, 1])
    bi = torch.tensor([M - 1, 0, 160, M - 1, M - 1])
    want = ak.traceback_dense(bp, bj, bi, preds, start)
    got = ak.graph_traceback_dense(*(x.to(cuda) for x in (bp, bj, bi, preds, start)))
    _equal(got, want)
    assert ak.graph_traceback_dense_plan(got[0].new_empty((1, 1, M), dtype=torch.int16)
                                         )["copy_bytes"] == _copy_bytes(M, 2)
    assert int((want[0] >= 0).sum(dim=1).max()) > 150  # long walks


def test_graph_dense_kernels_reject_bad_operands(cuda):
    from sina_tpu_torch.ops import align_kernel as ak

    ops, width, maxd, _ = _random_dag(1, 2, 40, 50, 4)
    args = [torch.from_numpy(a).to(cuda) for a in ops.values()]
    args.append(torch.ones((2, width), device=cuda))
    with pytest.raises(ValueError, match="ring"):
        ak.graph_dp_dense(*args, DpParams(), maxd=41)
    bad = list(args)
    bad[3] = bad[3].long()
    with pytest.raises(TypeError):
        ak.graph_dp_dense(*bad, DpParams(), maxd=maxd)
    bad[3] = torch.full((2, 40, 9), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="P"):
        ak.graph_dp_dense(*bad, DpParams(), maxd=maxd)
    with pytest.raises(ValueError):
        ak.graph_dp_dense(*args[:3], args[3].cpu(), *args[4:], DpParams(), maxd=maxd)


# run in a child process: a failed device-side assert leaves the
# process's CUDA context unusable
_SHALLOW_RING = """
import sys
import torch
sys.path.insert(0, "tests")
from test_torch_cuda import _random_dag
from sina_tpu_torch.ops import align_kernel as ak
from sina_tpu_torch.ops.align_kernel import DpParams
ops, width, maxd, _ = _random_dag(1, 2, 40, 50, 4)
dev = torch.device("cuda", 0)
args = [torch.from_numpy(a).to(dev) for a in ops.values()]
args.append(torch.ones((2, width), device=dev))
try:
    ak.graph_dp_dense(*args, DpParams(), maxd=maxd - 1)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def test_graph_dp_dense_raises_on_a_ring_too_shallow(cuda):
    """A maxd below the largest predecessor distance would read ring
    rows already overwritten: the kernel fails a device-side assert,
    which the next synchronising call raises, instead of returning a
    wrong alignment."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _SHALLOW_RING], cwd=root,
                         capture_output=True, text=True, timeout=600)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    assert "raised:" in res.stdout and "assert" in out, out


# the first graph DP launches of a process, at shapes whose dynamic shared
# memory fits 48 KB but not beside the kernel's static shared memory: a
# launch there needs the opt-in, which no earlier launch has made
_FIRST_LAUNCH = """
import sys
import torch
sys.path.insert(0, "tests")
from test_torch_cuda import _graph_bucket, _random_dag
from sina_tpu_torch.ops import align_kernel as ak
from sina_tpu_torch.ops import graph_kernel as gk
from sina_tpu_torch.ops.align_kernel import DpParams

dev = torch.device("cuda", 0)


def edge(plan):
    return plan["dyn_smem"] <= 48 * 1024 < plan["dyn_smem"] + plan["static_smem"]


ops, _, width, k = _graph_bucket(7, 2, 3, 64)
shape = next(((M, K) for M in range(64, 2049, 16) for K in range(k, 33)
              if edge(gk.graph_dp_plan(M, K, False))), None)
if shape is not None:
    M, K = shape
    ops, _, width, _ = _graph_bucket(7, 2, 3, M)
    args = list(ops.values()) + [torch.ones((2, width))]
    want = gk.graph_dp_plain(*args, params=DpParams(), k_ring=K)
    got = gk.graph_dp(*[a.to(dev) for a in args], params=DpParams(), k_ring=K)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    print("graph_dp at", shape)
ops, width, maxd, _ = _random_dag(5, 2, 60, 64, 4)
shape = next(((M, d) for M in range(64, 2049, 16) for d in range(maxd, 61)
              if edge(ak.graph_dp_dense_plan(M, False, d))), None)
if shape is not None:
    M, d = shape
    ops, width, _, _ = _random_dag(5, 2, 60, M, 4)
    args = [torch.from_numpy(a) for a in ops.values()] + [torch.ones((2, width))]
    want = ak.graph_dp_dense(*args, DpParams(), maxd=d)
    got = ak.graph_dp_dense(*[a.to(dev) for a in args], DpParams(), maxd=d)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    print("graph_dp_dense at", shape)
"""


def test_graph_dps_opt_in_beside_static_shared_memory(cuda):
    """A process's first graph DP launch (and dense DP launch) at a
    shape whose dynamic shared memory is at most 48 KB but more with
    the static: the launcher opts in by the two together, so the
    launch runs (it failed with "invalid argument" where only the
    dynamic part was tested) and equals the plain version."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _FIRST_LAUNCH], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "graph_dp at" in res.stdout, res.stdout


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


# -- transfers (ops/transfer): pinned staging, one upload a profile
# launch, fetches that wait for their own copy only, no hidden
# synchronisation on the dispatch paths


def _transfer_case(engine: str, long_insertion: bool = False):
    """A small reference, 16 queries and their famfinder families on the
    card (FamFinder on `cuda`), and the aligner config of `engine`
    (graph with a 40-base insertion in every other reference puts every
    bucket on the dense route)."""
    from sina_tpu_torch import testing
    from sina_tpu_torch.align import AlignerConfig
    from sina_tpu_torch.famfinder import FamFinder, FamFinderConfig

    db = testing.make_reference(n_seqs=80, n_core=300, width=500, seed=5)
    if long_insertion:
        db = testing.with_long_insertion(db, 40, 2, seed=3)
    qs = [testing.unaligned_copy(q) for q in testing.make_queries(db, n=16, seed=6,
                                                                 branch_len=0.6)]
    cfg = dict(profile=AlignerConfig(), forbid=AlignerConfig(insertion="forbid"),
               graph=AlignerConfig(engine="graph"),
               dense=AlignerConfig(engine="graph"))[engine]
    ff = FamFinder(db, FamFinderConfig(fs_min=10, fs_max=10, fs_full_len=250,
                                       fs_req_gaps=1), torch.device("cuda", 0))
    return ff, qs, cfg


def _families(ff, qs):
    return [r.family if not r.failed else [] for r in ff.process_batch(qs)]


def test_transfer_upload_and_fetch_are_pinned_and_counted(cuda):
    from sina_tpu_torch.ops import transfer

    transfer.reset_counts()
    a = np.arange(3 * 70_000, dtype=np.int32).reshape(3, -1)
    t = transfer.upload(a, cuda)
    f = transfer.fetch_async(t * 3)
    np.testing.assert_array_equal(f.result(), a * 3)
    assert transfer.counts == {"h2d": 1, "d2h": 1}
    bufs = transfer.pool_buffers()
    assert bufs and all(b.is_pinned() for b in bufs)
    with pytest.raises(ValueError, match="not pinned"):
        transfer.upload(torch.zeros(4), cuda)


def test_fetch_returns_while_later_work_runs(cuda):
    """result() waits for its own copy only: a 0.5 s sleep kernel queued
    after the fetch on the compute stream is still running when it
    returns."""
    from sina_tpu_torch.ops import transfer

    x = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
    f = transfer.fetch_async(x * 2)
    torch.cuda._sleep(int(1e9))
    after = torch.cuda.Event()
    after.record()
    got = f.result()
    assert not after.query()
    np.testing.assert_array_equal(got, np.arange(1 << 20, dtype=np.int32) * 2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("engine", ["profile", "graph"])
def test_batch_fetch_returns_while_later_work_runs(cuda, engine):
    """A batch's famfinder and alignment fetches return while work
    queued after them is still running; the records equal the CPU's."""
    from sina_tpu_torch.align import align_dispatch, align_finalize

    ff, qs, cfg = _transfer_case(engine)
    handle = ff.submit_batch(qs)
    torch.cuda._sleep(int(1e9))
    after = torch.cuda.Event()
    after.record()
    results = ff.process_batch(qs, handle=handle)
    assert not after.query()
    torch.cuda.synchronize()
    fams = [r.family if not r.failed else [] for r in results]
    state = align_dispatch([q.copy() for q in qs], [list(f) for f in fams], cfg,
                           device=cuda)
    torch.cuda._sleep(int(1e9))
    after = torch.cuda.Event()
    after.record()
    got = align_finalize(state)
    assert not after.query()
    torch.cuda.synchronize()
    want = align_finalize(align_dispatch([q.copy() for q in qs], [list(f) for f in fams],
                                         cfg, device="cpu"))
    assert [None if a is None else a.get_aligned() for a in got] == \
           [None if a is None else a.get_aligned() for a in want]


@pytest.mark.parametrize("engine", ["profile", "forbid", "graph", "dense"])
def test_dispatch_does_not_synchronise(cuda, engine):
    """famfinder.submit_batch and align_dispatch of a batch raise
    nothing under torch.cuda.set_sync_debug_mode("error"); each profile
    launch makes one host-to-device copy; every staging buffer is
    pinned."""
    from sina_tpu_torch.align import align_dispatch, align_finalize
    from sina_tpu_torch.ops import transfer
    from sina_tpu_torch.timing import get_timer, reset_all

    ff, qs, cfg = _transfer_case(engine, long_insertion=engine == "dense")
    fams = _families(ff, qs)
    align_finalize(align_dispatch(qs, [list(f) for f in fams], cfg, device=cuda))  # warm
    kernels.reset_launches()
    reset_all()
    transfer.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = ff.submit_batch(qs)
        state = align_dispatch(qs, [list(f) for f in fams], cfg, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ff.process_batch(qs, handle=handle)
    align_finalize(state)
    if engine in ("profile", "forbid"):
        n = get_timer("ProfileDP").counts["launch"]
        assert n > 0 and get_timer("ProfileDP").counts["h2d"] == n
        # famfinder's ids and one wire a launch
        assert transfer.counts["h2d"] == 1 + n
    if engine == "dense":
        assert kernels.launches["graph_dense_route"] == get_timer("GraphDP").counts["launch"] > 0
    bufs = transfer.pool_buffers()
    assert bufs and all(b.is_pinned() for b in bufs)
