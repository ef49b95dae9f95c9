"""Batching behaviour of the port's famfinder stage
(tests/test_famfinder_batching.py:39-137, counted through the port's
calls): a half-reversed batch is rescored in one second call, the
constraint escalation refetches through a growing top-k and never full
score rows, and duplicate queries are scored once, also through the
pipelined submit handle, whose fetch starts at submit
(ops/transfer.fetch_async).  Each batch's families also equal the JAX
package's on the same reference."""

import pytest
import torch

from sina_tpu import testing as jax_testing
from sina_tpu.famfinder import FamFinder as JaxFamFinder
from sina_tpu.famfinder import FamFinderConfig as JaxConfig
from sina_tpu_torch import testing
from sina_tpu_torch.famfinder import FamFinder, FamFinderConfig

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dbs():
    """The reference of the JAX tests, made by the port and by the JAX
    package from the same seed."""
    return (testing.make_reference(n_seqs=60, n_core=500, width=800, seed=7),
            jax_testing.make_reference(n_seqs=60, n_core=500, width=800, seed=7))


def _counting(ff):
    """Wrap score_topk / score_batch with call counters."""
    calls = {"topk": [], "batch": 0}
    orig_topk, orig_batch = ff.score_topk, ff.score_batch

    def topk(mask_list, k):
        calls["topk"].append((len(mask_list), k))
        return orig_topk(mask_list, k)

    def batch(mask_list):
        calls["batch"] += 1
        return orig_batch(mask_list)

    ff.score_topk = topk
    ff.score_batch = batch
    return calls


def _names(results):
    return [None if r is None else [(round(sc, 4), s.name) for sc, s in r.family]
            for r in results]


def test_revcomp_heavy_batch_two_scoring_calls(dbs):
    """Half-revcomp input: one initial call + ONE batched rescore for
    all reoriented queries."""
    db, jdb = dbs
    ff = FamFinder(db, FamFinderConfig(turn="revcomp", fs_req_gaps=0), CPU)
    queries = [testing.unaligned_copy(db.sequences[i]) for i in range(8)]
    jqueries = [jax_testing.unaligned_copy(jdb.sequences[i]) for i in range(8)]
    for q in queries[::2] + jqueries[::2]:
        q.reverse().complement()
    calls = _counting(ff)
    out = ff.process_batch(queries)
    assert len(calls["topk"]) == 2
    assert calls["topk"][1][0] == 4  # the 4 reoriented queries, batched
    assert calls["batch"] == 0
    for b, (q, res) in enumerate(zip(queries, out)):
        expect = "reversed and complemented" if b % 2 == 0 else "none"
        assert q.get_attr("turn_slv") == expect
        assert not res.failed
        assert q.name in [s.name for _, s in res.family]
    want = JaxFamFinder(jdb, JaxConfig(turn="revcomp", fs_req_gaps=0)).process_batch(jqueries)
    assert _names(out) == _names(want)


def test_escalation_uses_topk_ladder_not_full_rows():
    """Constraint escalation refetches via a growing device top-k,
    never by shipping full (B, n_seqs) score rows."""
    db = testing.make_reference(n_seqs=300, n_core=400, width=700, seed=11)
    ff = FamFinder(db, FamFinderConfig(fs_min_len=10_000, fs_req_gaps=0), CPU)
    queries = [testing.unaligned_copy(db.sequences[i]) for i in range(3)]
    calls = _counting(ff)
    out = ff.process_batch(queries)
    assert calls["batch"] == 0  # no full-row fetch
    # initial k0=256 call + one ladder rung at k = n_seqs
    assert len(calls["topk"]) == 2
    assert calls["topk"][1] == (3, 300)
    assert all(r is not None and r.failed for r in out)
    # the same through the submit handle: the escalation keeps its
    # eager fetch after the handle's
    calls = _counting(ff)
    handle = ff.submit_batch(queries)
    out = ff.process_batch(queries, handle=handle)
    assert calls["topk"] == [(3, 300)]
    assert all(r is not None and r.failed for r in out)


def test_escalation_ladder_matches_full_scoring():
    """Ladder refetch is behaviour-identical to full-row scoring, and
    to the JAX package's ladder."""
    db = testing.make_reference(n_seqs=300, n_core=400, width=700, seed=11)
    jdb = jax_testing.make_reference(n_seqs=300, n_core=400, width=700, seed=11)
    ff = FamFinder(db, FamFinderConfig(fs_req_gaps=0), CPU)
    q = testing.unaligned_copy(db.sequences[5])
    via_batch = ff.process_batch([q.copy()])[0]
    scores = ff.score_batch([q.masks])[0]
    via_full = ff._finish(q.copy(), scores=scores)
    # top-k ties resolve to lowest id, _rank to highest (documented
    # deviation) -> compare as score-sorted multisets
    got = sorted((round(sc, 4), s.name) for sc, s in via_batch.family)
    want = sorted((round(sc, 4), s.name) for sc, s in via_full.family)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert len(got) == len(want)
    jff = JaxFamFinder(jdb, JaxConfig(fs_req_gaps=0))
    jq = jax_testing.unaligned_copy(jdb.sequences[5])
    assert _names([via_batch]) == _names(jff.process_batch([jq]))


def test_duplicate_queries_scored_once(dbs):
    """Base-identical queries collapse to one scoring row; results fan
    back out per query."""
    db, jdb = dbs
    ff = FamFinder(db, FamFinderConfig(fs_req_gaps=0), CPU)
    qs = [testing.unaligned_copy(db.sequences[i % 4]) for i in range(16)]
    calls = _counting(ff)
    out = ff.process_batch(qs)
    assert len(calls["topk"]) == 1
    assert calls["topk"][0][0] == 4  # 4 distinct reads, not 16
    assert calls["batch"] == 0
    for i in (0, 5, 10, 15):
        assert out[i] is not None and not out[i].failed
    fams = [[s.name for _, s in out[i].family] for i in (0, 4, 8, 12)]
    assert fams[0] == fams[1] == fams[2] == fams[3]
    jqs = [jax_testing.unaligned_copy(jdb.sequences[i % 4]) for i in range(16)]
    assert _names(out) == _names(JaxFamFinder(jdb, JaxConfig(fs_req_gaps=0)).process_batch(jqs))


def test_duplicate_queries_submit_handle(dbs):
    """The pipelined submit path scores the deduped rows only, padded
    to a power-of-two bucket; its handle carries the started fetch of
    the (rows, 2k) [values | ids] result."""
    db, jdb = dbs
    ff = FamFinder(db, FamFinderConfig(fs_req_gaps=0), CPU)
    qs = [testing.unaligned_copy(db.sequences[i % 8]) for i in range(64)]
    calls = _counting(ff)
    fetch, k0, inv = ff.submit_batch(qs)
    assert calls["topk"] == []
    assert fetch.result().shape == (16, 2 * k0)  # 8 unique -> 16 rows, not 64
    assert inv.max() == 7
    out = ff.process_batch(qs, handle=(fetch, k0, inv))
    assert calls["topk"] == []
    assert all(r is not None and not r.failed for r in out)
    assert [s.name for _, s in out[0].family] == [s.name for _, s in out[8].family]
    jff = JaxFamFinder(jdb, JaxConfig(fs_req_gaps=0))
    jqs = [jax_testing.unaligned_copy(jdb.sequences[i % 8]) for i in range(64)]
    assert _names(out) == _names(jff.process_batch(jqs, handle=jff.submit_batch(jqs)))


def test_submit_of_nothing_or_with_the_turn_check_gives_no_handle(dbs):
    """No handle for an empty batch or the turn check (it scores
    eagerly); process_batch of an empty batch is empty."""
    db, _ = dbs
    ff = FamFinder(db, FamFinderConfig(fs_req_gaps=0), CPU)
    assert ff.submit_batch([]) is None and ff.process_batch([]) == []
    turn = FamFinder(db, FamFinderConfig(turn="revcomp", fs_req_gaps=0), CPU)
    assert turn.submit_batch([testing.unaligned_copy(db.sequences[0])]) is None
