"""tests/test_subst_matrix.py and tests/test_bps.py on the port's CPU
path: the substitution-matrix scheme (sina_tpu_torch.stats and the
graph engine with --use-subst-matrix) and the helix pair score through
the port's Pipeline, each beside the JAX package on the same fixtures.
Every case keeps the original's assertions, made on the port; the
matrix and frequencies must equal the JAX package's to the last bit,
the aligned records and the pipeline's statistics exactly."""

import numpy as np
import pytest
import torch

import sina_tpu.align as jalign
from sina_tpu import testing as jtesting
from sina_tpu.famfinder import FamFinderConfig as JaxFamFinderConfig
from sina_tpu.pipeline import Pipeline as JaxPipeline
from sina_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from sina_tpu.sequence import Sequence as JaxSequence
from sina_tpu.stats import family_base_freqs as jax_family_base_freqs
from sina_tpu.stats import subst_matrix as jax_subst_matrix
from sina_tpu_torch import align as talign
from sina_tpu_torch import testing as ttesting
from sina_tpu_torch.comparator import COVER_QUERY, IUPAC_EXACT, Comparator
from sina_tpu_torch.famfinder import FamFinderConfig
from sina_tpu_torch.pipeline import Pipeline, PipelineConfig
from sina_tpu_torch.sequence import Sequence
from sina_tpu_torch.stats import family_base_freqs, subst_matrix

CPU = torch.device("cpu")


def test_subst_matrix_formula():
    f = np.full(4, 0.25)
    m = subst_matrix(f, identity=0.9)
    # diagonal: -log((0.9/4) / (0.25*0.25))
    assert m[0, 0] == pytest.approx(-np.log(0.225 / 0.0625), rel=1e-5)
    # off-diagonal: -log(((0.1)/12) / 0.0625)
    assert m[0, 1] == pytest.approx(-np.log((0.1 / 12) / 0.0625), rel=1e-5)
    # matches must be rewarded (negative cost) vs mismatches
    assert (np.diag(m) < m[~np.eye(4, dtype=bool)].min()).all()
    np.testing.assert_array_equal(m, jax_subst_matrix(f, identity=0.9))
    skewed = np.array([0.4, 0.3, 0.2, 0.1])
    np.testing.assert_array_equal(subst_matrix(skewed, identity=0.8),
                                  jax_subst_matrix(skewed, identity=0.8))


def test_family_base_freqs():
    f = family_base_freqs([Sequence.from_string("a", "AAGG"),
                           Sequence.from_string("b", "AARR")])  # R = A|G split half/half
    assert f.sum() == pytest.approx(1.0)
    assert f[0] == pytest.approx(5.0 / 8.0)  # A: 2 + 2 + 2*0.5
    assert f[1] == pytest.approx(3.0 / 8.0)  # G
    assert f[2] == 0 and f[3] == 0
    np.testing.assert_array_equal(
        f, jax_family_base_freqs([JaxSequence.from_string("a", "AAGG"),
                                  JaxSequence.from_string("b", "AARR")]))


def test_subst_matrix_alignment_end_to_end():
    kw = dict(realign=True, use_subst_matrix=True)
    cfg, jcfg = talign.AlignerConfig(**kw), jalign.AlignerConfig(**kw)
    assert cfg.resolved_engine() == "graph"
    db = ttesting.make_reference(n_seqs=60, n_core=300, width=500, seed=9)
    jdb = jtesting.make_reference(n_seqs=60, n_core=300, width=500, seed=9)
    cmp_exact = Comparator(IUPAC_EXACT, "none", COVER_QUERY, False)
    for true_q, jtrue_q in zip(ttesting.make_queries(db, n=3, seed=4, branch_len=0.4),
                               jtesting.make_queries(jdb, n=3, seed=4, branch_len=0.4)):
        pid = db.index_of(true_q.get_attr("parent"))
        out = talign.align_sequence(
            ttesting.unaligned_copy(true_q),
            [(0.9, db.sequences[(pid + k) % len(db)]) for k in range(8)], cfg, device=CPU)
        want = jalign.align_sequence(
            jtesting.unaligned_copy(jtrue_q),
            [(0.9, jdb.sequences[(pid + k) % len(jdb)]) for k in range(8)], jcfg)
        assert out is not None
        assert out.get_bases().upper() == true_q.get_bases().upper()
        # alignment must land close to the true column placement
        assert cmp_exact(true_q, out) > 0.8
        assert "using dist:" in out.get_attr("align_log_slv", "")
        assert out.positions.tolist() == want.positions.tolist()
        assert out.masks.tolist() == want.masks.tolist()
        stamp = "aligned_slv"
        assert ({k: v for k, v in out.attrs.items() if k != stamp}
                == {k: v for k, v in want.attrs.items() if k != stamp})


def test_fs_no_graph_ignores_matrix():
    kw = dict(fs_no_graph=True, use_subst_matrix=True)
    assert talign.AlignerConfig(**kw).resolved_engine() == "profile"
    assert jalign.AlignerConfig(**kw).resolved_engine() == "profile"


def test_bps_flows_through_pipeline(tmp_path):
    db = ttesting.make_reference(n_seqs=80, n_core=300, width=500, seed=5, n_stems=10)
    jdb = jtesting.make_reference(n_seqs=80, n_core=300, width=500, seed=5, n_stems=10)
    p, jp = tmp_path / "ref.sref", tmp_path / "jref.sref"
    db.save(p)
    jdb.save(jp)
    common = dict(outputs=[], show_dist=True, select_step=10, batch_size=8)
    r = Pipeline(PipelineConfig(
        in_path=str(p), db=str(p), device="cpu",
        famfinder=FamFinderConfig(fs_full_len=200, fs_req_gaps=1),
        aligner=talign.AlignerConfig(realign=True), **common)).run()
    jr = JaxPipeline(JaxPipelineConfig(
        in_path=str(jp), db=str(jp),
        famfinder=JaxFamFinderConfig(fs_full_len=200, fs_req_gaps=1),
        aligner=jalign.AlignerConfig(realign=True), **common)).run()
    # planted complementary stems: realigned sequences must show a
    # positive pairing score on average
    assert r["avg_bps"] > 0.3, r
    clock = ("elapsed", "seq_per_s")
    assert ({k: v for k, v in r.items() if k not in clock}
            == {k: v for k, v in jr.items() if k not in clock})
