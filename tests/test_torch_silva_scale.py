"""The port's k-mer scoring and top-k at the widths of a SILVA NR index.

A 450,000-reference index pads to 450,560 references: 56,320 bytes a row
of the bitpacked matrix and 56,320 groups of 8 in the grouped top-k.
These run at those widths with few k-mer rows, against the JAX package
on the CPU (its XLA scorer and its own grouped_top_k), with numpy inputs
from a seed.  Scores are integer counts: every comparison is exact.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sina_tpu.famfinder import _score_topk_compiled
from sina_tpu.ops.kmer_index import KmerIndex
from sina_tpu.ops.kmer_kernel import grouped_top_k as jax_grouped_top_k
from sina_tpu.ops.kmer_kernel import kmer_scores_packed_xla
from sina_tpu_torch.ops import kmer_index as port_index
from sina_tpu_torch.ops import kmer_kernel as kk
from sina_tpu_torch.ops.kmer_index import device_matrix

N_SEQS = 450_000
S_PAD = 450_560
SB = S_PAD // 8
REPO = Path(__file__).resolve().parents[1]


def _tied_scores(seed: int) -> np.ndarray:
    """(4, 450,560) int32 scores from 0-12, so that every k-th value is
    tied among tens of thousands of references, with eight distinct top
    scores (40..33) a row at random references: their groups rank first
    in the grouped top-k and carry tied members of high ids with them."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 13, (4, S_PAD)).astype(np.int32)
    for row in scores:
        row[rng.choice(S_PAD, 8, replace=False)] = np.arange(40, 32, -1)
    return scores


@pytest.mark.parametrize("k", [8, 256, 1000])
def test_grouped_topk_equals_jax_at_450560(k):
    """grouped_top_k with its first stage from the scorer's group maxima
    and without them: values and ids equal to the JAX package's
    grouped_top_k.  Above k = 8 the k-th value is tied, and the ids
    differ from a flat lowest-id top-k's."""
    scores = _tied_scores(k)
    jv, ji = (np.asarray(a) for a in jax_grouped_top_k(jnp.asarray(scores), k))
    st = torch.from_numpy(scores)
    for gmax in (None, kk.group_max_plain(st)):
        v, i = kk.grouped_top_k(st, k, gmax)
        np.testing.assert_array_equal(v.numpy(), jv)
        np.testing.assert_array_equal(i.numpy(), ji)
    _, flat = kk.top_k_lowest_id(st, k)
    assert np.array_equal(flat.numpy(), ji) == (k == 8)
    kth = jv[:, -1:]
    assert ((scores == kth).sum(axis=1) > (jv == kth).sum(axis=1)).all() == (k > 8)


def _packed_case(rng, R: int = 300, B: int = 4, L: int = 512):
    """A random (R, 56,320) packed matrix (its last row the all-zero sink)
    and B queries of L ids: up to 360 random ids and then the sink, as
    famfinder pads them, one of them sorted; at L = 512 one query holds
    one id 200 times."""
    P = rng.integers(0, 256, (R, SB), dtype=np.uint8)
    P[-1] = 0
    n = min(L, 360)
    kmers = np.full((B, L), R - 1, np.int32)
    kmers[:, :n] = rng.integers(0, R - 1, (B, n))
    kmers[1, 100:300] = 17
    kmers[2, :n].sort()
    return P, kmers


def test_plain_scores_and_group_maxima_equal_xla_at_56320():
    """kmer_scores_plain and group_max_plain at Sb = 56,320 bit-equal to
    the JAX package's kmer_scores_packed_xla."""
    P, kmers = _packed_case(np.random.default_rng(56))
    want = np.asarray(kmer_scores_packed_xla(jnp.asarray(P), jnp.asarray(kmers)))
    scores = kk.kmer_scores_plain(torch.from_numpy(P), torch.from_numpy(kmers))
    assert scores.shape == (4, S_PAD) and scores.dtype == torch.int32
    np.testing.assert_array_equal(scores.numpy(), want)
    np.testing.assert_array_equal(kk.group_max_plain(scores).numpy(),
                                  want.reshape(4, SB, 8).max(axis=2))
    # the query that holds row 17 200 times scores 200 on each of its bits
    assert scores.numpy()[1].max() >= 200


def test_plain_scorer_blocks_give_the_same_sums(monkeypatch):
    """With the plain scorer's blocks held to three unpacked rows (3
    queries and 1 k-mer at a time), its scores at Sb = 56,320 are the
    JAX package's, as with whole blocks."""
    P, kmers = _packed_case(np.random.default_rng(57), L=40)
    kmers[1, 10:30] = 17
    want = np.asarray(kmer_scores_packed_xla(jnp.asarray(P), jnp.asarray(kmers)))
    monkeypatch.setattr(kk, "_PLAIN_BYTES", 3 * 8 * SB)
    assert kk._blocks(4, 40, 8 * SB) == (3, 1)
    got = kk.kmer_scores_plain(torch.from_numpy(P), torch.from_numpy(kmers))
    np.testing.assert_array_equal(got.numpy(), want)


def _tied_index(rng, B: int = 3, L: int = 48):
    """Packed matrix of L + 1 rows whose scores are set by construction
    over 450,560 references: the query hits rows 0..L-1 once each and
    reference s has bits in rows 0..c_s-1, so score(s) = c_s; eight
    distinct top scores 40..33, the rest 0-12."""
    c = rng.integers(0, 13, S_PAD)
    c[rng.choice(S_PAD, 8, replace=False)] = np.arange(40, 32, -1)
    bits = np.arange(L + 1)[:, None] < c[None, :]
    bits[-1] = False
    P = np.packbits(bits, axis=1, bitorder="little")
    kmers = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    kmers[1, ::2] = L                          # padding k-mers
    kmers[2] = rng.integers(0, L + 1, L)       # repeats
    return P, kmers


@pytest.mark.parametrize("k", [8, 256, 1000])
def test_score_topk_equals_jax_at_450560(k):
    """score_topk at 450,560 padded references against the JAX
    package's scoring + top-k (_score_topk_compiled, its grouped path):
    values and ids equal, tie order included."""
    P, kmers = _tied_index(np.random.default_rng(450 + k))
    assert P.shape == (49, SB)
    packed = np.asarray(_score_topk_compiled(k)(jnp.asarray(P), jnp.asarray(kmers)))
    got = kk.score_topk(torch.from_numpy(P), torch.from_numpy(kmers), k).numpy()
    np.testing.assert_array_equal(got[:, :k], packed[:, :k])
    np.testing.assert_array_equal(got[:, k:], packed[:, k:])


def test_packed_width_at_450000_references():
    """An index of 450,000 references over 3-mers (65 rows with the
    sink): dense_packed pads to 450,560 references, 56,320 bytes a row,
    equal to the JAX package's bytes (carried across as CSR arrays); the
    560 padding references score 0, and the tiled layout of a 4-shard
    mesh pads to 65,536 bytes as the JAX package's does."""
    rng = np.random.default_rng(450_000)
    counts = rng.integers(0, 5, N_SEQS)
    offsets = np.zeros(N_SEQS + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    # each reference's k-mers: a run of `count` distinct 3-mers from a random start
    within = np.arange(offsets[-1]) - np.repeat(offsets[:-1], counts)
    postings = ((np.repeat(rng.integers(0, 64, N_SEQS), counts) + within) % 64).astype(np.int32)
    ref = KmerIndex(3, False, N_SEQS, postings, offsets)
    idx = port_index.KmerIndex.from_arrays(postings, offsets, N_SEQS, 3, False)
    P = idx.dense_packed()
    assert P.shape == (65, SB)
    np.testing.assert_array_equal(P, ref.dense_packed())
    tiled = idx.dense_packed_tiled(byte_multiple=4096 * 4)
    assert tiled.shape == (65, 32, 2048)
    np.testing.assert_array_equal(tiled, ref.dense_packed_tiled(byte_multiple=4096 * 4))
    Pt = device_matrix(idx, torch.device("cpu"))
    assert tuple(Pt.shape) == (65, SB)
    kmers = np.full((2, 80), 64, np.int32)
    kmers[:, :64] = np.arange(64)
    scores = kk.kmer_scores(Pt, torch.from_numpy(kmers)).numpy()
    # every reference holds each of its k-mers once: it scores their count
    np.testing.assert_array_equal(scores[:, :N_SEQS], np.tile(counts, (2, 1)))
    assert not scores[:, N_SEQS:].any()


def test_plain_scorer_stays_inside_its_memory_at_56320():
    """At B = 64 and L = 32 against 56,320-byte rows, unpacking 32
    k-mers of every query at once takes 1.8 GB of temporaries; the plain
    scorer, run in a child process whose address space may grow by 1.5
    GiB past what it used after a warm-up, finishes with the right
    sum."""
    code = textwrap.dedent("""
        import resource, torch
        from sina_tpu_torch.ops import kmer_kernel as kk
        torch.set_num_threads(2)
        g = torch.Generator().manual_seed(0)
        P = torch.randint(0, 256, (300, 56_320), dtype=torch.uint8, generator=g)
        P[-1] = 0
        kmers = torch.randint(0, 300, (64, 32), dtype=torch.int32, generator=g)
        kk.kmer_scores_plain(P, kmers[:2])
        peak = [ln for ln in open("/proc/self/status") if ln.startswith("VmPeak")][0]
        limit = int(peak.split()[1]) * 1024 + (3 << 29)
        resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
        print(int(kk.kmer_scores_plain(P, kmers).sum(dtype=torch.int64)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    g = torch.Generator().manual_seed(0)
    P = torch.randint(0, 256, (300, 56_320), dtype=torch.uint8, generator=g)
    P[-1] = 0
    kmers = torch.randint(0, 300, (64, 32), dtype=torch.int32, generator=g)
    ones = np.unpackbits(P.numpy(), axis=1).sum(axis=1)
    assert int(out.stdout.split()[0]) == int(ones[kmers.numpy()].sum())
