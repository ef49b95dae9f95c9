"""tests/test_accuracy.py's prealigned, copy-path, leave-query-out and
k-mer index cases on the port (device "cpu": the plain PyTorch versions
of its kernels), on test_torch_accuracy.py's bundle, with the
reference's bars unchanged (accuracy_kmer.test:17-67).  For the
prealigned and copy paths and the k = 8 and no-fast indexes the port's
aggregates must also equal the JAX package's Pipeline on the same
bundle."""

import pytest

from test_torch_accuracy import _one_torch_thread, bundle, jax_run, run  # noqa: F401

AGGREGATES = ("n_in", "n_aligned", "avg_sps", "avg_cpm", "avg_idty", "avg_bps")


def same_as_jax(bundle, r, **kw):
    want = jax_run(bundle, **kw)
    assert {k: r[k] for k in AGGREGATES} == {k: want[k] for k in AGGREGATES}


def test_prealigned(bundle):
    """tests/test_accuracy.py:65-70."""
    r = run(bundle, prealigned=True)
    assert r["n_aligned"] == 48
    assert r["avg_sps"] == pytest.approx(1.0)
    assert r["avg_cpm"] == pytest.approx(0.0)
    same_as_jax(bundle, r, prealigned=True)


def test_align_copy(bundle):
    """tests/test_accuracy.py:73-79: without --realign the query (present
    in the reference) is copied verbatim."""
    r = run(bundle, step=1000)
    assert r["n_aligned"] == 5
    assert r["avg_sps"] == pytest.approx(1.0)
    assert r["avg_idty"] == pytest.approx(1.0, abs=1e-6)
    same_as_jax(bundle, r, step=1000)


def test_realign_leave_query_out(bundle):
    """tests/test_accuracy.py:92-98: cpm < 0.00025."""
    r = run(bundle, realign=True, fs_leave_query_out=True, engine="graph")
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.00025, r
    assert r["avg_idty"] > 0.96, r


def test_realign_k8(bundle):
    """tests/test_accuracy.py:112-119 (--fs-kmer-len 8)."""
    kw = dict(realign=True, fs_leave_query_out=True, fs_kmer_len=8, engine="graph")
    r = run(bundle, **kw)
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.0002, r
    assert r["avg_idty"] > 0.96, r
    same_as_jax(bundle, r, **kw)


def test_realign_nofast(bundle):
    """tests/test_accuracy.py:122-129 (--fs-kmer-no-fast): the tightest
    cpm."""
    kw = dict(realign=True, fs_leave_query_out=True, fs_no_fast=True, engine="graph")
    r = run(bundle, **kw)
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.00015, r
    assert r["avg_idty"] > 0.96, r
    same_as_jax(bundle, r, **kw)
