"""The port's spans and counters (sina_tpu_torch.timing) through
Pipeline.run on a tiny reference, both engines, on the CPU: spans nest
in their parents, every batch has one read, submit, dispatch, finalize
and write in pipeline order, the timers' sections are the sums of
their spans, set-up spans appear once a pipeline and a run span once a
run, a generation-2 collection is a span under the section it
interrupted, the ring drops its oldest span and counts it, a profiler
session sees every span as a record_function range, and a batch with a
repeated family counts fewer distinct profile rows than rows and an
identity-cache hit."""

import gc
import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from sina_tpu_torch import testing, timing
from sina_tpu_torch.align import AlignerConfig
from sina_tpu_torch.famfinder import FamFinderConfig
from sina_tpu_torch.io.fasta import FastaWriter
from sina_tpu_torch.pipeline import Pipeline, PipelineConfig
from sina_tpu_torch.sequence import Sequence

ENGINES = ("profile", "graph")
FAM = dict(fs_min=8, fs_max=8, fs_full_len=150, fs_req_gaps=1)
CHAIN = ("pipeline.read", "pipeline.submit", "pipeline.dispatch", "pipeline.finalize",
         "Pipeline/write+stats")
SETUP = ("setup.pipeline", "setup.refdb_open", "setup.kmer_index_load",
         "setup.kmer_index_upload")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A tiny reference bundle, 10 full-length queries, and 4 fragments
    of 110 bases, each twice (so each batch repeats its families)."""
    d = tmp_path_factory.mktemp("trace")
    db = testing.make_reference(n_seqs=50, n_core=250, width=400, seed=77)
    db.save(d / "ref.sref")
    qs = testing.make_queries(db, n=10, seed=7, branch_len=0.6)
    with FastaWriter(str(d / "q.fasta")) as w:
        for q in qs:
            w.write(testing.unaligned_copy(q))
    with FastaWriter(str(d / "frag.fasta")) as w:
        for i, q in enumerate(qs[:4]):
            m = q.masks[40:150]
            for c in "ab":
                w.write(Sequence(f"F{i}{c}", np.arange(len(m), dtype=np.uint32), m, len(m), {}))
    return d


def fresh_store(mp: pytest.MonkeyPatch, capacity: int = timing.SPAN_CAPACITY):
    """An empty span store, timer registry and counters for one test."""
    mp.setattr(timing, "store", timing.SpanStore(capacity))
    mp.setattr(timing, "_registry", {})
    mp.setattr(timing, "counters", defaultdict(int))


@pytest.fixture(autouse=True)
def one_thread():
    """The plain graph DP loops over nodes: parallel workers only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pipeline(d, engine, queries="q.fasta", batch_size=4, **aligner):
    return Pipeline(PipelineConfig(
        in_path=str(d / queries), outputs=[("fasta", str(d / f"out-{engine}.fasta"))],
        db=str(d / "ref.sref"), device="cpu", batch_size=batch_size,
        famfinder=FamFinderConfig(**FAM, fs_min_len=50),
        aligner=AlignerConfig(engine=engine, **aligner)))


@pytest.fixture(scope="module", params=ENGINES)
def traced(request, env):
    """One pipeline on `engine`, run twice, with what its store holds."""
    with pytest.MonkeyPatch.context() as mp:
        torch.set_num_threads(1)
        fresh_store(mp)
        pipe = pipeline(env, request.param)
        summaries = [pipe.run(), pipe.run()]
        spans = timing.spans()
        timers = {n: (dict(t.sections), dict(t.counts)) for n, t in timing._registry.items()}
    return request.param, summaries, spans, timers


def test_spans_nest_in_parents(traced):
    _, _, spans, _ = traced
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans) > 0
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
            assert s.thread == p.thread
            if s.batch is None:
                assert p.batch is None


def test_batch_chain_in_pipeline_order(traced):
    """Each batch: one read, submit, dispatch, finalize and write, in
    that order; every span of a batch inside one of them."""
    _, summaries, spans, _ = traced
    runs = [s for s in spans if s.name == "pipeline.run"]
    chains = defaultdict(list)
    for s in spans:
        if s.name in CHAIN and s.batch is not None:
            chains[s.batch].append(s)
            assert s.parent in {r.id for r in runs}
    assert len(chains) == 2 * 3  # 10 queries in batches of 4, twice
    for bid, chain in chains.items():
        assert [s.name for s in sorted(chain, key=lambda s: s.t0)] == list(CHAIN), bid
    # the read of the input's end carries no batch, once a run
    assert sum(1 for s in spans if s.name == "pipeline.read" and s.batch is None) == 2
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.batch is not None and s.name not in CHAIN:
            top = s
            while top.name not in CHAIN:
                top = by_id[top.parent]
            assert top.batch == s.batch
    assert [x["n_in"] for x in summaries] == [10, 10]


def test_sections_equal_their_spans(traced):
    _, _, spans, timers = traced
    total, n = defaultdict(float), Counter()
    for s in spans:
        total[s.name] += (s.t1 - s.t0) * 1e-9
        n[s.name] += 1
    assert {"Pipeline", "Kmer Search", "Aligner"} <= set(timers)
    for name, (secs, counts) in timers.items():
        assert secs.keys() == counts.keys()
        for sec, v in secs.items():
            assert n[f"{name}/{sec}"] == counts[sec]
            assert total[f"{name}/{sec}"] == pytest.approx(v, rel=1e-12, abs=1e-12)


def test_setup_spans_once_and_one_run_span_a_run(traced):
    _, _, spans, _ = traced
    names = Counter(s.name for s in spans)
    for name in SETUP:
        assert names[name] == 1, name
        assert next(s for s in spans if s.name == name).keep
    assert names["pipeline.run"] == 2
    setup = next(s for s in spans if s.name == "setup.pipeline")
    runs = [s for s in spans if s.name == "pipeline.run"]
    for name in ("setup.refdb_open", "setup.kmer_index_load"):
        s = next(s for s in spans if s.name == name)
        assert s.parent == setup.id
    upload = next(s for s in spans if s.name == "setup.kmer_index_upload")
    assert runs[0].t0 <= upload.t0 and upload.t1 <= runs[0].t1
    assert all(r.parent is None and r.batch is None for r in runs)
    # the counters at each run's start and end: nothing counts between
    # the runs, and the runs count the same work but the references the
    # bundle makes: once, in the first run that names them
    (a0, a1), (b0, b1) = runs[0].counters, runs[1].counters
    assert a1 == b0 and a1 != a0
    first = {k: v - a0.get(k, 0) for k, v in a1.items()}
    second = {k: v - b0.get(k, 0) for k, v in b1.items()}
    assert first.pop("refdb.materialized") > 0 == second.pop("refdb.materialized")
    assert first == second


def test_gc_gen2_span_under_interrupted_section(monkeypatch):
    fresh_store(monkeypatch)
    t = timing.get_timer("Test")
    gc.collect(2)  # outside a run: no span
    with timing.run_span("pipeline.run") as run:
        with t.section("work", batch=7):
            gc.collect(2)
            gc.collect(0)
    gc.collect(2)
    spans = timing.spans()
    section = next(s for s in spans if s.name == "Test/work")
    gcs = [s for s in spans if s.name == "gc.gen2"]
    assert gcs and section.parent == run.id
    for g in gcs:
        assert g.parent == section.id and g.batch == 7
        assert section.t0 <= g.t0 <= g.t1 <= section.t1
    assert timing._gc_span not in gc.callbacks


def test_full_ring_drops_oldest_and_counts(monkeypatch):
    fresh_store(monkeypatch, capacity=3)
    with timing.span("setup.x", keep=True):
        for i in range(5):
            with timing.span(f"s{i}"):
                pass
    names = [s.name for s in timing.spans()]
    assert names == ["setup.x", "s2", "s3", "s4"]
    assert timing.counters["timing.spans_dropped"] == 2


def test_profiler_sees_every_span(env, monkeypatch):
    """A run (prealigned: the pipeline's own spans, without the plain
    DPs' many operators to record) and a section inside the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fresh_store(monkeypatch)
    pipe = Pipeline(PipelineConfig(in_path=str(env / "q.fasta"), prealigned=True,
                                   outputs=[("fasta", str(env / "pre.fasta"))], batch_size=4,
                                   device="cpu"))
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        pipe.run()
        with timing.get_timer("Test").section("work"):
            pass
    spans = [s for s in timing.spans() if s.t0 >= t0]
    names = Counter(s.name for s in spans)
    assert names["pipeline.run"] == 1 and names["pipeline.read"] == 4
    assert names["Pipeline/write+stats"] == 3 and names["Test/work"] == 1
    ranges = Counter(e.name for e in prof.events())
    for name, n in names.items():
        assert ranges[name] == n, name
    # a batch's ranges carry its id as their input
    assert sorted(e.concrete_inputs[0] for e in prof.events() if e.name == "pipeline.submit") \
        == sorted(s.batch for s in spans if s.name == "pipeline.submit")
    # outside a profiler session no range opens
    with timing.span("x") as s:
        assert s._range is None


def test_repeated_family_counters(env, monkeypatch):
    """Fragments repeated in one batch: the profile rows dedup (U < B)
    and the column trim's caches hit."""
    fresh_store(monkeypatch)
    pipeline(env, "profile", queries="frag.fasta", batch_size=8, col_trim_min_cols=0).run()
    c = timing.counters
    assert 0 < c["profile.distinct"] < c["profile.rows"] <= 8
    assert sum(v for k, v in c.items() if k.startswith("cache.") and k.endswith(".hit")) > 0
    assert sum(v for k, v in c.items() if k.startswith("cache.") and k.endswith(".miss")) > 0
