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
    """At >= 32,768 refs the reference's grouped_top_k keeps the exact
    values but orders equal values by group rank; the port stays exact
    lowest-id.  Ids must agree wherever the k-th value is untied."""
    rng = np.random.default_rng(8)
    P, kmers = _tied_index(rng, 32768)
    rv, ri = _split(np.asarray(_score_topk_compiled(k)(jnp.asarray(P), jnp.asarray(kmers))), k)
    gv, gi = _split(kk.score_topk(torch.from_numpy(P), torch.from_numpy(kmers), k).numpy(), k)
    np.testing.assert_array_equal(gv, rv)
    scores = kk.kmer_scores_plain(torch.from_numpy(P), torch.from_numpy(kmers)).numpy()
    untied_rows = 0
    for b in range(len(kmers)):
        kth = gv[b, -1]
        # the port: for each value, the lowest ids holding it, ascending
        for v in np.unique(gv[b]):
            have = np.flatnonzero(scores[b] == v)
            np.testing.assert_array_equal(gi[b][gv[b] == v], have[: (gv[b] == v).sum()])
            assert set(ri[b][rv[b] == v]) <= set(have.tolist())
            if v > kth:
                assert set(ri[b][rv[b] == v]) == set(gi[b][gv[b] == v])
        if (scores[b] == kth).sum() == (gv[b] == kth).sum():
            untied_rows += 1
            np.testing.assert_array_equal(np.sort(gi[b]), np.sort(ri[b]))
            if len(np.unique(gv[b])) == k:
                np.testing.assert_array_equal(gi[b], ri[b])
    if k == 8:
        assert untied_rows >= 1
