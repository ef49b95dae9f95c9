"""The accuracy bars of tests/test_accuracy.py, on the port.

The port's Pipeline (device "cpu": the plain PyTorch versions of its
kernels) realigns every 104th sequence of the same generated
LTP-like bundle (testing.make_reference_ltp(5000, seed=1234)) against
the whole bundle with --show-dist semantics, and must clear the
reference's own thresholds unchanged (accuracy_kmer.test): avg_sps
(identity with the original alignment), avg_cpm (closest-reference
identity drift) and avg_idty, for the graph engine and the profile
engine.  The fs-msc-max degradation curve (test_realign_msc_capped)
is not ported yet: on the plain versions it takes two minutes."""

import pytest
import torch

from sina_tpu import testing
from sina_tpu_torch.align import AlignerConfig
from sina_tpu_torch.famfinder import FamFinderConfig
from sina_tpu_torch.pipeline import Pipeline, PipelineConfig


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    d = tmp_path_factory.mktemp("acc")
    db = testing.make_reference_ltp(5000, seed=1234)
    path = d / "ref.sref"
    db.save(path)
    return str(path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small tensor operations: under
    the test run's parallel workers, torch's intra-op threads would
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(bundle, step=104, **kw):
    fam_kw = dict(
        fs_full_len=1200, fs_req_gaps=1,
        fs_leave_query_out=kw.pop("fs_leave_query_out", False),
        fs_msc_max=kw.pop("fs_msc_max", 2.0),
    )
    ali_kw = dict(
        realign=kw.pop("realign", False),
        engine=kw.pop("engine", "auto"),
    )
    cfg = PipelineConfig(
        in_path=bundle,
        db=bundle,
        outputs=[],
        show_dist=True,
        select_step=step,
        famfinder=FamFinderConfig(**fam_kw),
        aligner=AlignerConfig(**ali_kw),
        batch_size=48,
        device="cpu",
        **kw,
    )
    return Pipeline(cfg).run()


def test_realign(bundle):
    """accuracy_kmer.test:34-40: avg_sps > 0.996, avg_cpm < 0.0002,
    avg_idty > 0.96 (tests/test_accuracy.py:82-89)."""
    r = run(bundle, realign=True, engine="graph")
    assert r["n_aligned"] == 48
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.0002, r
    assert r["avg_idty"] > 0.96, r


def test_realign_profile_engine(bundle):
    """The profile engine: the reference's sps bar, cpm < 0.0005
    (tests/test_accuracy.py:101-109)."""
    r = run(bundle, realign=True, engine="profile")
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.0005, r
    assert r["avg_idty"] > 0.96, r
