"""The seven cases of tests/test_accuracy_multiseed.py on the port.

The port's FamFinder, align_dispatch and align_finalize (device "cpu":
the plain PyTorch versions of its kernels) run each case's fixture,
rebuilt with the port's own testing module (the same generator, the
same seeds, the same data), and must clear that file's bars unchanged,
per-query floors included: the reference's realign bars on fresh
fixture seeds, the profile engine's worst case, divergent (branch 1.4)
queries and partial-length 240-nt reads.  On seed 777 with the graph
engine the per-query sps must equal the JAX package's, float for
float."""

import numpy as np
import pytest
import torch

from sina_tpu_torch import testing


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small tensor operations: under
    the test run's parallel workers, torch's intra-op threads would
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [777, 2024])
def test_realign_bars_hold_on_fresh_seeds(seed):
    """tests/test_accuracy_multiseed.py:65-77; on seed 777 the per-query
    sps equal the JAX package's _realign_metrics."""
    db = testing.make_reference_ltp(3000, seed=seed)
    sps, cpm = testing.realign_metrics(db)
    assert len(sps) >= 40
    assert sps.mean() > 0.996, sps.mean()
    assert cpm.mean() < 0.0003, cpm.mean()
    assert sps.min() > 0.99, sps.min()
    assert cpm.max() < 0.003, cpm.max()
    if seed == 777:
        from sina_tpu import testing as jax_testing
        from test_accuracy_multiseed import _realign_metrics

        jax_sps, jax_cpm = _realign_metrics(jax_testing.make_reference_ltp(3000, seed=seed))
        assert sps.tolist() == jax_sps.tolist()
        assert cpm.tolist() == jax_cpm.tolist()


def test_realign_worst_case_profile_engine():
    """tests/test_accuracy_multiseed.py:80-88."""
    db = testing.make_reference_ltp(3000, seed=777)
    sps, cpm = testing.realign_metrics(db, engine="profile")
    assert sps.mean() > 0.996, sps.mean()
    assert sps.min() > 0.985, sps.min()
    assert cpm.max() < 0.005, cpm.max()


@pytest.mark.parametrize("seed", [11, 12])
def test_divergent_queries_degrade_gracefully(seed):
    """tests/test_accuracy_multiseed.py:111-125: branch_len 1.4."""
    db = testing.make_reference(n_seqs=1000, n_core=1200, width=2000, seed=seed)
    truths = testing.make_queries(db, n=40, seed=seed + 1, branch_len=1.4)
    sps = testing.align_vs_truth(db, [testing.unaligned_copy(q) for q in truths], truths)
    assert sps.mean() > 0.975, sps.mean()
    assert sps.min() > 0.95, sps.min()


@pytest.mark.parametrize("seed", [11, 12])
def test_partial_length_queries(seed):
    """tests/test_accuracy_multiseed.py:128-157: 240-nt mid-gene reads
    scored against the sliced true alignment."""
    db = testing.make_reference(n_seqs=1000, n_core=1200, width=2000, seed=seed)
    reads, truths = testing.partial_reads(db, seed)
    sps = testing.align_vs_truth(db, reads, truths)
    assert sps.mean() > 0.97, sps.mean()
    assert sps.min() > 0.90, sps.min()
