"""Edge cases through the port's pipeline (tests/test_edge_cases.py:
36-146): empty input, queries shorter than k, an all-N query, a
one-sequence database, an impossible fs_req and a query longer than the
reference span, on both engines with the plain versions (device cpu).
Each sends nothing, empty buckets or one-row buckets through the
transfer handles (a famfinder submit of nothing, a bucket of one
query); the port's summary and output FASTA must equal the JAX
package's pipeline on the same files.  And the alignment at SILVA's
width of 50,000 columns on both engines."""

import pytest
import torch

from sina_tpu import testing
from sina_tpu.align import AlignerConfig as JaxAlignerConfig
from sina_tpu.famfinder import FamFinderConfig as JaxFamFinderConfig
from sina_tpu.io.fasta import FastaWriter
from sina_tpu.pipeline import Pipeline as JaxPipeline
from sina_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from sina_tpu.refdb import ReferenceDb as JaxReferenceDb
from sina_tpu.testing import unaligned_copy
from sina_tpu_torch.align import AlignerConfig
from sina_tpu_torch.famfinder import FamFinderConfig
from sina_tpu_torch.io.fasta import read_fasta
from sina_tpu_torch.pipeline import Pipeline, PipelineConfig

ENGINES = ("profile", "graph")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("edge")
    db = testing.make_reference(n_seqs=50, n_core=250, width=400, seed=77)
    dbp = d / "ref.sref"
    db.save(dbp)
    return d, db, dbp


@pytest.fixture(autouse=True)
def one_thread():
    """The plain graph DP loops over nodes: parallel workers only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(dbp, qf, out, engine, fam=None, realign=False):
    """The JAX package's and the port's pipelines on the same files:
    (JAX summary, port summary, port output path)."""
    fam = dict(fs_min=8, fs_max=8, fs_full_len=150, fs_req_gaps=1, **(fam or {}))
    jout = out.with_suffix(".jax.fasta")
    jr = JaxPipeline(JaxPipelineConfig(
        in_path=str(qf), outputs=[("fasta", str(jout))], db=str(dbp),
        famfinder=JaxFamFinderConfig(**fam),
        aligner=JaxAlignerConfig(realign=realign, engine=engine))).run()
    r = Pipeline(PipelineConfig(
        in_path=str(qf), outputs=[("fasta", str(out))], db=str(dbp), device="cpu",
        famfinder=FamFinderConfig(**fam),
        aligner=AlignerConfig(realign=realign, engine=engine))).run()
    assert (r["n_in"], r["n_aligned"]) == (jr["n_in"], jr["n_aligned"])
    assert out.read_bytes() == jout.read_bytes()
    return jr, r


@pytest.mark.parametrize("engine", ENGINES)
def test_empty_input(env, tmp_path, engine):
    _, _, dbp = env
    qf = tmp_path / "empty.fasta"
    qf.write_text("")
    _, r = _run_both(dbp, qf, tmp_path / "o.fasta", engine)
    assert r["n_in"] == 0 and r["n_aligned"] == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_short_query(env, tmp_path, engine):
    """Shorter than k: no k-mers, every id the sink row; aligned or
    cleanly skipped, never a crash."""
    _, _, dbp = env
    qf = tmp_path / "short.fasta"
    qf.write_text(">tiny\nACGU\n>tinier\nAG\n")
    _, r = _run_both(dbp, qf, tmp_path / "o.fasta", engine)
    assert r["n_in"] == 2


@pytest.mark.parametrize("engine", ENGINES)
def test_all_ambiguous_query(env, tmp_path, engine):
    _, _, dbp = env
    qf = tmp_path / "n.fasta"
    qf.write_text(">allN\n" + "N" * 60 + "\n")
    _, r = _run_both(dbp, qf, tmp_path / "o.fasta", engine)
    assert r["n_in"] == 1


@pytest.mark.parametrize("engine", ENGINES)
def test_single_sequence_db(env, tmp_path, engine):
    _, db, _ = env
    one = tmp_path / "one.sref"
    JaxReferenceDb(db.sequences[:1], db.width).save(one)
    qf = tmp_path / "q.fasta"
    with FastaWriter(qf) as w:
        w.write(unaligned_copy(db.sequences[0]))
    _, r = _run_both(one, qf, tmp_path / "o.fasta", engine, fam=dict(fs_req=1))
    assert r["n_aligned"] == 1  # copy path from itself


@pytest.mark.parametrize("engine", ENGINES)
def test_fs_req_drop(env, tmp_path, engine):
    """An impossible requirement drops the query, never crashes."""
    _, db, dbp = env
    qf = tmp_path / "q.fasta"
    with FastaWriter(qf) as w:
        w.write(unaligned_copy(testing.make_queries(db, n=1, seed=5)[0]))
    out = tmp_path / "o.fasta"
    _, r = _run_both(dbp, qf, out, engine, fam=dict(fs_req=49, fs_min_len=390))
    assert r["n_in"] == 1 and r["n_aligned"] == 0
    assert len(list(read_fasta(out))) == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_query_longer_than_reference_span(env, tmp_path, engine):
    """A bucket of one query with 20 bases past each end of its parent."""
    _, db, dbp = env
    parent = db.sequences[0]
    extra = "ACGUACGUACGUACGUACGU"
    qf = tmp_path / "q.fasta"
    qf.write_text(f">long\n{extra}{parent.get_bases()}{extra}\n")
    out = tmp_path / "o.fasta"
    _, r = _run_both(dbp, qf, out, engine, realign=True)
    assert r["n_aligned"] == 1
    got = list(read_fasta(out))[0]
    assert len(got.get_bases()) == len(parent.get_bases()) + 40


@pytest.mark.parametrize("engine", ENGINES)
def test_silva_width_alignment(engine):
    """Alignment at SILVA SSU's width (50,000 columns): sequences keep
    only their occupied positions and the DP runs over the family's
    columns or nodes, not the width.  The aligned row equals the JAX
    package's."""
    from sina_tpu.align import align_sequence as jax_align
    from sina_tpu_torch import testing as port_testing
    from sina_tpu_torch.align import align_sequence
    from sina_tpu_torch.comparator import COVER_QUERY, IUPAC_EXACT, Comparator

    jdb = testing.make_reference_large(60, n_core=300, width=50_000, seed=17)
    db = port_testing.make_reference_large(60, n_core=300, width=50_000, seed=17)
    assert db.width == 50_000
    q0, jq0 = db.sequences[7], jdb.sequences[7]
    fam = [(1.0, s) for s in db.sequences[:40] if s.name != q0.name]
    jfam = [(1.0, s) for s in jdb.sequences[:40] if s.name != jq0.name]
    out = align_sequence(port_testing.unaligned_copy(q0), fam,
                         AlignerConfig(engine=engine, realign=True), device="cpu")
    want = jax_align(unaligned_copy(jq0), jfam, JaxAlignerConfig(engine=engine, realign=True))
    assert out is not None and out.width == 50_000
    sps = Comparator(IUPAC_EXACT, "none", COVER_QUERY, False)(q0, out)
    assert sps > 0.9, (engine, sps)
    assert out.get_aligned() == want.get_aligned()
