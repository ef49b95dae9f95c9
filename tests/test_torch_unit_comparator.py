"""tests/test_comparator.py and tests/test_score_many.py on the port's
comparator (sina_tpu_torch.comparator, its own copy of the JAX
package's with its own native library): every case keeps the
original's assertions, made on the port, and the port's values must
equal the JAX package's on the same fixtures (NaN where it is NaN)."""

import numpy as np
import pytest

import sina_tpu.comparator as jcmp
from sina_tpu import native as jnative
from sina_tpu import testing as jtesting
from sina_tpu.sequence import Sequence as JaxSequence
from sina_tpu_torch import native as tnative
from sina_tpu_torch import testing as ttesting
from sina_tpu_torch.comparator import (
    COVER_ABS, COVER_ALL, COVER_AVERAGE, COVER_MAX, COVER_MIN, COVER_NOGAP,
    COVER_OVERLAP, COVER_QUERY, COVER_TARGET, DIST_JC, IUPAC_EXACT,
    IUPAC_OPTIMISTIC, IUPAC_PESSIMISTIC, Comparator, jukes_cantor,
)
from sina_tpu_torch.sequence import Sequence

# columns:  a: A2 G3 C4 U5 A7 G8 G9
#           b: C1 A2 G3 U4 U5 G8 G9 A10
# common: 2(AA match) 3(GG) 4(C/U mm) 5(UU) 8(GG) 9(GG) -> 5 match 1 mm;
# only_a: 7 (inside b's span); b1 and b10 outside a's span: overhangs
A_STR, B_STR = "--AGCU-AGG--", "-CAGUU--GGA-"


def pair(a: str, b: str):
    """(port pair, JAX pair) of the same two sequences."""
    return ((Sequence.from_string("a", a), Sequence.from_string("b", b)),
            (JaxSequence.from_string("a", a), JaxSequence.from_string("b", b)))


def both(iupac, dist, cover, filter_lc):
    """(port comparator, JAX comparator) of one rule set."""
    return (Comparator(iupac, dist, cover, filter_lc),
            jcmp.Comparator(iupac, dist, cover, filter_lc))


def test_counts():
    (a, b), (ja, jb) = pair(A_STR, B_STR)
    m = Comparator().counts(a, b)
    assert m["match"] == 5
    assert m["mismatch"] == 1
    assert m["only_a"] == 1          # a7 inside b's span
    assert m["only_b"] == 0
    assert m["only_b_overhang"] == 2  # b1, b10
    assert m == jcmp.Comparator().counts(ja, jb)


def test_cover_rules():
    (a, b), (ja, jb) = pair(A_STR, B_STR)
    mm = 6  # match+mismatch
    vals = {
        COVER_ABS: 5 / 1,
        COVER_QUERY: 5 / (mm + 1),
        COVER_TARGET: 5 / (mm + 0 + 2),
        COVER_OVERLAP: 5 / (mm + 1 + 0),
        COVER_ALL: 5 / (mm + 1 + 0 + 0 + 2),
        COVER_AVERAGE: 5 / (mm + (1 + 2) // 2),
        COVER_MIN: 5 / (mm + min(1, 2)),
        COVER_MAX: 5 / (mm + max(1, 2)),
        COVER_NOGAP: 5 / mm,
    }
    for rule, expect in vals.items():
        c, jc = both(IUPAC_OPTIMISTIC, "none", rule, False)
        assert c(a, b) == pytest.approx(expect), rule
        assert c(a, b) == jc(ja, jb), rule


def test_iupac_rules():
    (x, y), (jx, jy) = pair("ARN", "AAA")
    want = {IUPAC_OPTIMISTIC: 1.0,      # all could match
            IUPAC_PESSIMISTIC: 1 / 3,   # only unambig A
            IUPAC_EXACT: 1 / 3}         # codes equal only at 0
    for rule, expect in want.items():
        c, jc = both(rule, "none", COVER_QUERY, False)
        assert c(x, y) == pytest.approx(expect), rule
        assert c(x, y) == jc(jx, jy), rule


def test_jc_correction():
    (a, b), (ja, jb) = pair(A_STR, B_STR)
    c, jc = both(IUPAC_OPTIMISTIC, DIST_JC, COVER_QUERY, False)
    raw = Comparator(IUPAC_OPTIMISTIC, "none", COVER_QUERY, False)
    assert c(a, b) == pytest.approx(jukes_cantor(raw(a, b)))
    assert c(a, b) == jc(ja, jb)
    assert jukes_cantor(0.6) == jcmp.jukes_cantor(0.6)


def test_filter_lowercase():
    (x, y), (jx, jy) = pair("AGcU", "AGAU")
    nofilter, jnofilter = both(IUPAC_OPTIMISTIC, "none", COVER_QUERY, False)
    filt, jfilt = both(IUPAC_OPTIMISTIC, "none", COVER_QUERY, True)
    assert nofilter(x, y) == pytest.approx(3 / 4)
    # lowercase c dropped from x -> y's A at that column becomes
    # only_b, which COVER_QUERY ignores
    assert filt(x, y) == pytest.approx(3 / 3)
    assert (nofilter(x, y), filt(x, y)) == (jnofilter(jx, jy), jfilt(jx, jy))


def dbs(**kw):
    """(port, JAX) reference of the same generator arguments."""
    return ttesting.make_reference(**kw), jtesting.make_reference(**kw)


@pytest.mark.parametrize(
    "iupac,cover,dist,filter_lc",
    [
        (IUPAC_OPTIMISTIC, COVER_QUERY, "none", False),
        (IUPAC_EXACT, COVER_OVERLAP, "none", False),
        (IUPAC_OPTIMISTIC, COVER_TARGET, DIST_JC, False),
        (IUPAC_OPTIMISTIC, COVER_NOGAP, "none", True),
    ],
)
def test_score_many_matches_pairwise(iupac, cover, dist, filter_lc):
    """The vectorised many-vs-one comparator matches the pairwise one,
    and both packages' many-vs-one scores agree."""
    db, jdb = dbs(n_seqs=40, n_core=200, width=400, seed=17)
    q = ttesting.make_queries(db, n=1, seed=3)[0]
    jq = jtesting.make_queries(jdb, n=1, seed=3)[0]
    cmp, jc = both(iupac, dist, cover, filter_lc)
    ids = np.arange(len(db))
    many = cmp.score_many(q, *_packed(db), ids, db.width)
    jmany = jc.score_many(jq, *_packed(jdb), ids, jdb.width)
    np.testing.assert_array_equal(many, jmany)
    for i in range(len(db)):
        expect = cmp(q, db.sequences[i])
        if np.isnan(expect):
            # JC of identity > 3/4 is NaN in both implementations
            # (and in the reference's log of a negative argument)
            assert np.isnan(many[i]), i
        else:
            assert many[i] == pytest.approx(expect, abs=1e-9), i


def _packed(db):
    """(flat_pos, flat_masks, offsets) in score_many's argument order."""
    offsets, flat_pos, flat_masks = db.packed_arrays()
    return flat_pos, flat_masks, offsets


def test_native_and_python_paths_agree(monkeypatch):
    """The port's native and Python paths agree, and equal the JAX
    package's native path (the pessimistic rule and the min, max,
    average, all and abs cover bases)."""
    db, jdb = dbs(n_seqs=30, n_core=150, width=300, seed=4)
    q = ttesting.make_queries(db, n=1, seed=9)[0]
    jq = jtesting.make_queries(jdb, n=1, seed=9)[0]
    ids = np.arange(len(db))
    assert tnative.get_lib() is not None and jnative.get_lib() is not None
    for iupac in (IUPAC_OPTIMISTIC, IUPAC_PESSIMISTIC, IUPAC_EXACT):
        for cover in (COVER_ALL, COVER_MIN, COVER_MAX, COVER_AVERAGE, COVER_ABS):
            cmp, jc = both(iupac, "none", cover, False)
            got_native = cmp.score_many(q, *_packed(db), ids, db.width)
            with monkeypatch.context() as mp:
                mp.setattr(tnative, "score_counts", lambda *a, **k: None)
                got_py = cmp.score_many(q, *_packed(db), ids, db.width)
            np.testing.assert_allclose(got_native, got_py, atol=1e-12,
                                       err_msg=f"{iupac}/{cover}")
            np.testing.assert_array_equal(
                got_native, jc.score_many(jq, *_packed(jdb), ids, jdb.width))


def test_score_many_batch_matches_per_query():
    """The one-call threaded batch scorer reproduces per-query
    score_many exactly, including ragged candidate lists and queries
    with different spans and rules, and equals the JAX package's."""
    db, jdb = dbs(n_seqs=40, n_core=150, width=300, seed=5)
    qs = ttesting.make_queries(db, n=6, seed=11)
    jqs = jtesting.make_queries(jdb, n=6, seed=11)
    rng = np.random.default_rng(0)
    ids_list = [np.sort(rng.choice(len(db), size=n, replace=False))
                for n in (40, 17, 3, 40, 25, 1)]
    offsets, flat_pos, flat_masks = db.packed_arrays()
    joffsets, jflat_pos, jflat_masks = jdb.packed_arrays()
    for iupac in (IUPAC_OPTIMISTIC, IUPAC_EXACT):
        for cover in (COVER_ALL, COVER_MIN):
            cmp, jc = both(iupac, "none", cover, False)
            batch = cmp.score_many_batch(qs, flat_pos, flat_masks, offsets, ids_list, db.width)
            jbatch = jc.score_many_batch(jqs, jflat_pos, jflat_masks, joffsets, ids_list,
                                         jdb.width)
            for q, ids, got, want in zip(qs, ids_list, batch, jbatch):
                np.testing.assert_allclose(
                    got, cmp.score_many(q, flat_pos, flat_masks, offsets, ids, db.width),
                    atol=1e-12, err_msg=f"{iupac}/{cover}")
                np.testing.assert_array_equal(got, want)

