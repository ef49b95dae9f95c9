"""The port's k-mer scorers and top-k against the JAX package.

Scores are integer counts: every comparison is exact.  The JAX side
runs its Pallas kernels in interpret mode and its XLA path on the CPU
(the dense scorer's Pallas kernel has no interpret switch: its CPU
route is kmer_scores_xla).  A JAX-package index reaches the port as
its CSR arrays (KmerIndex.from_arrays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sina_tpu import testing
from sina_tpu.famfinder import _score_topk_compiled
from sina_tpu.ops.kmer import query_kmers_padded
from sina_tpu.ops.kmer_index import KmerIndex
from sina_tpu.ops.kmer_kernel import (
    kmer_scores_packed_pallas,
    kmer_scores_packed_tiled_pallas,
    kmer_scores_packed_xla,
    kmer_scores_xla,
)
from sina_tpu_torch.ops import kmer_index as port_index
from sina_tpu_torch.ops import kmer_kernel as kk
from sina_tpu_torch.ops.kmer_index import device_matrix

CPU = torch.device("cpu")


def carry(idx: KmerIndex) -> port_index.KmerIndex:
    """The JAX package's index carried into the port as numpy arrays."""
    return port_index.KmerIndex.from_arrays(
        idx.seq_kmers, idx.seq_offsets, idx.n_seqs, idx.k, idx.fast)


def test_packed_scores_match_pallas_and_xla():
    # the fixture of test_kmer.py::test_packed_incidence_matches_dense
    db = testing.make_reference(n_seqs=50, n_core=200, width=400, seed=11)
    idx = KmerIndex.build(db, k=8, fast=True)
    Pp = idx.dense_packed()
    masks = [s.masks for s in db.sequences[:6]]
    kmers, _ = query_kmers_padded(masks, 8, fast=True, pad_to=256)
    pal = np.asarray(
        kmer_scores_packed_pallas(jnp.asarray(Pp), kmers, interpret=True)
    )
    xla = np.asarray(kmer_scores_packed_xla(jnp.asarray(Pp), kmers))
    P = device_matrix(carry(idx), CPU)
    got = kk.kmer_scores(P, torch.from_numpy(kmers)).numpy()
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, xla)
    # the self-retrieval invariant of test_kmer.py
    n = idx.n_seqs
    assert (got[np.arange(6), np.arange(6)] == got[:, :n].max(axis=1)).all()


def test_random_matrix_with_out_of_range_ids():
    rng = np.random.default_rng(0)
    Pp = rng.integers(0, 256, (257, 16), dtype=np.uint8)
    Pp[-1] = 0
    kmers = rng.integers(0, 257, (13, 40), dtype=np.int32)
    xla = np.asarray(kmer_scores_packed_xla(jnp.asarray(Pp), jnp.asarray(kmers)))
    got = kk.kmer_scores(torch.from_numpy(Pp), torch.from_numpy(kmers)).numpy()
    np.testing.assert_array_equal(got, xla)
    # famfinder never makes an id outside [0, R]; the port clamps one
    # into the matrix (past the end = the all-zero sink row) instead
    # of reading outside it
    bad = kmers.copy()
    bad[:, ::3] = 10_000
    sink = kmers.copy()
    sink[:, ::3] = 256
    got = kk.kmer_scores(torch.from_numpy(Pp), torch.from_numpy(bad)).numpy()
    xla = np.asarray(kmer_scores_packed_xla(jnp.asarray(Pp), jnp.asarray(sink)))
    np.testing.assert_array_equal(got, xla)


def test_tiled_view_matches_tiled_pallas():
    # the fixture of test_kmer.py::test_tiled_layout_matches_packed_scores
    db = testing.make_reference(n_seqs=300, n_core=200, width=360, seed=21)
    idx = KmerIndex.build(db, k=6, fast=False)
    P3 = idx.dense_packed_tiled()
    masks = [s.masks for s in db.sequences[:5]]
    kmers, _ = query_kmers_padded(masks, 6, fast=False, pad_to=128)
    pal = np.asarray(
        kmer_scores_packed_tiled_pallas(jnp.asarray(P3), kmers, interpret=True)
    )
    P = device_matrix(P3, CPU)
    assert P.shape == (P3.shape[0], 32 * P3.shape[2])
    got = kk.kmer_scores(P, torch.from_numpy(kmers)).numpy()
    np.testing.assert_array_equal(got, pal)
    # the 3-D tensor scores as its flat view
    got3 = kk.kmer_scores(torch.from_numpy(P3), torch.from_numpy(kmers)).numpy()
    np.testing.assert_array_equal(got3, pal)


def test_dense_scores_match_xla_and_packed():
    """The dense scorer (an int8 device_matrix, as the JAX package's
    device_matrix(packed=False)) against kmer_scores_xla on idx.dense()
    and against the packed scorer on the same index."""
    db = testing.make_reference(n_seqs=150, n_core=200, width=400, seed=12)
    idx = KmerIndex.build(db, k=8, fast=True)
    masks = [s.masks for s in db.sequences[:7]]
    kmers, _ = query_kmers_padded(masks, 8, fast=True, pad_to=320)
    want = np.asarray(kmer_scores_xla(jnp.asarray(idx.dense()), kmers))
    port = carry(idx)
    P8 = device_matrix(port, CPU, packed=False)
    assert P8.dtype == torch.int8 and P8.shape == idx.dense().shape
    assert P8.shape[1] % 128 == 0 and P8.shape[1] != 8 * port.dense_packed().shape[1]
    km = torch.from_numpy(kmers)
    got = kk.kmer_scores(P8, km).numpy()
    np.testing.assert_array_equal(got, want)
    packed = kk.kmer_scores(device_matrix(port, CPU), km).numpy()
    S = got.shape[1]
    np.testing.assert_array_equal(got, packed[:, :S])
    assert not packed[:, S:].any()
    # the self-retrieval invariant of test_kmer.py
    assert (got[np.arange(7), np.arange(7)] == got[:, :idx.n_seqs].max(axis=1)).all()


def test_dense_random_matrix_with_out_of_range_ids():
    rng = np.random.default_rng(4)
    P = rng.integers(0, 2, (257, 256), dtype=np.int8)
    P[-1] = 0
    packed = np.packbits(P.astype(bool), axis=1, bitorder="little")
    kmers = rng.integers(0, 257, (5, 77), dtype=np.int32)
    want = np.asarray(kmer_scores_xla(jnp.asarray(P), jnp.asarray(kmers)))
    got = kk.kmer_scores_dense_plain(torch.from_numpy(P), torch.from_numpy(kmers)).numpy()
    np.testing.assert_array_equal(got, want)
    # ids past the end clamp to the sink row, ids below 0 to row 0,
    # in the dense and the packed scorer alike
    bad = kmers.copy()
    bad[:, ::3] = 10_000
    bad[:, 1::5] = -7
    sink = np.where(bad >= 257, 256, np.maximum(bad, 0)).astype(np.int32)
    got = kk.kmer_scores(torch.from_numpy(P), torch.from_numpy(bad)).numpy()
    want = np.asarray(kmer_scores_xla(jnp.asarray(P), jnp.asarray(sink)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, kk.kmer_scores(torch.from_numpy(packed), torch.from_numpy(bad)).numpy())


def _tied_index(rng, n_refs: int):
    """Packed matrix whose scores are set by construction: the query
    hits rows 0..L-1 once each, and reference s has bits in rows
    0..c_s-1, so score(s) = c_s.  Eight references get the distinct
    top scores 40..33 (an untied k-th value at k=8); the rest score
    0..12, with heavy ties."""
    L = 48
    c = rng.integers(0, 13, n_refs)
    top = rng.choice(n_refs, 8, replace=False)
    c[top] = np.arange(40, 32, -1)
    bits = np.arange(L + 1)[:, None] < c[None, :]      # (L+1, S)
    bits[-1] = False                                   # the sink row
    P = np.packbits(bits, axis=1, bitorder="little")
    kmers = np.tile(np.arange(L, dtype=np.int32), (3, 1))
    kmers[1, ::2] = L                                  # padding k-mers
    kmers[2] = rng.integers(0, L + 1, L)               # repeats
    return P, kmers


def _split(packed, k):
    return packed[:, :k], packed[:, k:]


@pytest.mark.parametrize("k", [8, 256])
def test_topk_exact_below_32768(k):
    rng = np.random.default_rng(7)
    P, kmers = _tied_index(rng, 4096)
    rv, ri = _split(np.asarray(_score_topk_compiled(k)(jnp.asarray(P), jnp.asarray(kmers))), k)
    gv, gi = _split(kk.score_topk(torch.from_numpy(P), torch.from_numpy(kmers), k).numpy(), k)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gi, ri)


@pytest.mark.parametrize("k", [8, 256])
def test_topk_at_32768_values_exact_ids_lowest(k):
    """At >= 32,768 padded refs the JAX package ranks with
    grouped_top_k, which orders equal values at the k-th value by
    group rank; the port's score_topk takes the same path there, so
    values and ids are equal, tie order included."""
    rng = np.random.default_rng(8)
    P, kmers = _tied_index(rng, 32768)
    rv, ri = _split(np.asarray(_score_topk_compiled(k)(jnp.asarray(P), jnp.asarray(kmers))), k)
    gv, gi = _split(kk.score_topk(torch.from_numpy(P), torch.from_numpy(kmers), k).numpy(), k)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gi, ri)


@pytest.mark.parametrize("n_refs,k", [(4096, 1000), (32768, 1000), (100352, 8),
                                      (100352, 256), (100352, 1000)])
def test_topk_equals_jax_with_heavy_ties(n_refs, k):
    """k = 1000 (the search's candidates) and the 100,352 padded
    references of a 100k-reference index, on a matrix whose k-th value
    is tied among thousands of references: values and ids equal to
    _score_topk_compiled.  Where the grouped path runs with a tied k-th
    value, its ids differ from a flat lowest-id top-k's, so the test
    tells the two apart."""
    rng = np.random.default_rng(n_refs + k)
    P, kmers = _tied_index(rng, n_refs)
    rv, ri = _split(np.asarray(_score_topk_compiled(k)(jnp.asarray(P), jnp.asarray(kmers))), k)
    gv, gi = _split(kk.score_topk(torch.from_numpy(P), torch.from_numpy(kmers), k).numpy(), k)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gi, ri)
    _, flat = kk.top_k_lowest_id(kk.kmer_scores_plain(torch.from_numpy(P),
                                                      torch.from_numpy(kmers)), k)
    # _tied_index's top 8 scores are distinct: at k = 8 nothing is tied
    grouped_tied = n_refs >= kk.GROUPED_MIN_WIDTH and 16 * max(k, 256) < n_refs and k > 8
    assert np.array_equal(flat.numpy(), gi) != grouped_tied


def _gmax_case(case: str):
    """A random packed matrix of 300 rows (the last the all-zero sink
    row) and 4 queries of 512 ids shaped as `case`; returns (P, kmers,
    the ids clamped into the matrix)."""
    rng = np.random.default_rng(len(case))
    R, L = 300, 512
    P = rng.integers(0, 256, (R, 24), dtype=np.uint8)
    P[-1] = 0
    kmers = rng.integers(0, R - 1, (4, L), dtype=np.int32)
    if case == "repeats":
        kmers[:, 100:420] = 17            # one id 320 times in a row
        kmers[1, :] = 5                   # a query that holds one id only
        kmers[2, ::2] = 9                 # an id every other position
    elif case == "sorted_and_reversed":
        kmers[0].sort()
        kmers[1] = np.sort(kmers[1])[::-1]
        kmers[2, 360:] = R - 1            # real ids, then the sink row
    elif case == "all_sink":
        kmers[:] = R - 1
    elif case == "out_of_range":
        kmers[:, ::3] = rng.integers(-5, 0, kmers[:, ::3].shape)
        kmers[:, 1::3] = rng.integers(R, R + 40, kmers[:, 1::3].shape)
    return P, kmers, np.clip(kmers, 0, R - 1).astype(np.int32)


@pytest.mark.parametrize("case", ["random", "repeats", "sorted_and_reversed", "all_sink",
                                  "out_of_range"])
def test_group_max_matches_pallas_and_xla(case):
    """The scorer's second output (the maxima of each byte column's 8
    scores, grouped_top_k's first stage) and its scores, against the
    Pallas kernel in interpret mode and the XLA path, reshaped to
    (B, Sb, 8) and maxed over the last axis.  Ids outside the matrix
    clamp into it in the port (-5 is row 0, R + 3 the sink row), so the
    JAX side gets the clamped ids."""
    P, kmers, clamped = _gmax_case(case)
    B, Sb = kmers.shape[0], P.shape[1]
    pal = np.asarray(kmer_scores_packed_pallas(jnp.asarray(P), clamped, interpret=True))
    xla = np.asarray(kmer_scores_packed_xla(jnp.asarray(P), jnp.asarray(clamped)))
    scores, gmax = kk.kmer_scores(torch.from_numpy(P), torch.from_numpy(kmers), gmax=True)
    np.testing.assert_array_equal(scores.numpy(), pal)
    np.testing.assert_array_equal(scores.numpy(), xla)
    assert gmax.dtype == torch.int32 and gmax.shape == (B, Sb)
    np.testing.assert_array_equal(gmax.numpy(), pal.reshape(B, Sb, 8).max(axis=2))
    np.testing.assert_array_equal(gmax.numpy(), xla.reshape(B, Sb, 8).max(axis=2))
    np.testing.assert_array_equal(kk.group_max_plain(scores).numpy(), gmax.numpy())
    if case == "all_sink":
        assert not gmax.numpy().any()
    if case == "repeats":
        # the query of one id 512 times scores 512 on every bit of its row
        assert gmax.numpy()[1].max() == 512


def test_gmax_needs_the_packed_matrix():
    P8 = torch.zeros((5, 128), dtype=torch.int8)
    with pytest.raises(TypeError):
        kk.kmer_scores(P8, torch.zeros((1, 3), dtype=torch.int32), gmax=True)


@pytest.mark.parametrize("n_refs,k", [(32768, 256), (32768, 1000), (100352, 256),
                                      (100352, 1000)])
def test_grouped_topk_from_gmax_equals_jax(n_refs, k):
    """grouped_top_k with its first stage taken from the scorer's group
    maxima gives the values and ids of grouped_top_k without them and of
    the JAX package's grouped_top_k on the JAX scores, with the k-th
    value tied among thousands (the fixture of
    test_topk_equals_jax_with_heavy_ties)."""
    from sina_tpu.ops.kmer_kernel import grouped_top_k as jax_grouped_top_k

    rng = np.random.default_rng(n_refs + k)
    P, kmers = _tied_index(rng, n_refs)
    scores, gmax = kk.kmer_scores(torch.from_numpy(P), torch.from_numpy(kmers), gmax=True)
    gv, gi = kk.grouped_top_k(scores, k, gmax)
    av, ai = kk.grouped_top_k(scores, k)
    jax_scores = kmer_scores_packed_xla(jnp.asarray(P), jnp.asarray(kmers))
    jv, ji = (np.asarray(a) for a in jax_grouped_top_k(jax_scores, k))
    for got, want in ((gv, av), (gi, ai), (gv, jv), (gi, ji)):
        np.testing.assert_array_equal(got.numpy(), want)
    # the k-th value is tied: more references hold it than the top-k keeps
    kth = gv[:, -1:]
    assert ((scores == kth).sum(dim=1) > (gv == kth).sum(dim=1)).all()


@pytest.fixture(scope="module")
def synthetic_index():
    """A JAX-package KmerIndex over 100,000 synthetic references of
    0-12 random non-fast 4-mers each (100,352 padded): a query's scores
    are small counts, tied across thousands of references."""
    rng = np.random.default_rng(100)
    n_seqs = 100_000
    counts = rng.integers(0, 13, n_seqs)
    offsets = np.zeros(n_seqs + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    kmers = rng.integers(0, 4 ** 4, int(offsets[-1])).astype(np.int32)
    return KmerIndex(4, False, n_seqs, kmers, offsets)


@pytest.mark.parametrize("k", [8, 256, 1000])
def test_famfinder_score_topk_equals_jax_at_100352(synthetic_index, k):
    """FamFinder.score_topk on a JAX-package index of 100,000
    references (100,352 padded) carried into the port, against the JAX
    package's single-device scoring + top-k on the same index with its
    row padding and id masking (FamFinder.score_topk without a mesh)."""
    from sina_tpu.famfinder import FamFinder as JaxFamFinder
    from sina_tpu_torch import famfinder as port_famfinder
    from sina_tpu_torch import testing as port_testing

    rng = np.random.default_rng(100 + k)
    idx = synthetic_index
    masks = [(1 << rng.integers(0, 4, n)).astype(np.uint8) for n in (300, 120, 700)]
    kmers, _ = query_kmers_padded(masks, idx.k, fast=idx.fast)
    P = idx.dense_packed()
    assert 8 * P.shape[1] == 100_352
    padded = JaxFamFinder._pad_rows(kmers, P.shape[0] - 1)
    packed = np.asarray(_score_topk_compiled(k)(jnp.asarray(P), jnp.asarray(padded)))
    rv, ri = packed[:3, :k], packed[:3, k:]
    pad = ri >= idx.n_seqs
    rv, ri = np.where(pad, -1, rv), np.where(pad, 0, ri)

    db = port_testing.make_reference(n_seqs=20, n_core=100, width=200, seed=3)
    finder = port_famfinder.FamFinder(db, port_famfinder.FamFinderConfig(), CPU)
    finder.index = carry(idx)
    gv, gi = finder.score_topk(masks, k)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gi, ri)
    if k >= 256:
        # heavy ties: more references hold the k-th value than the top-k keeps
        scores = finder.score_batch(masks)
        for b in range(3):
            assert (scores[b] == gv[b, -1]).sum() > (gv[b] == gv[b, -1]).sum()
