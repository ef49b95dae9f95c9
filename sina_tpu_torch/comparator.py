"""Pairwise identity measures over aligned sequences.

Port of the semantics of cseq_comparator
(SINA src/cseq_comparator.cpp:57-293): a position-
synchronised traversal classifying bases as match/mismatch (shared
columns), only-A/only-B (gap in the other inside the overlap zone) or
overhang (outside the other's span), followed by one of nine coverage
normalisations and an optional Jukes-Cantor transform.  Vectorised as
numpy set operations on position arrays.
"""

from __future__ import annotations

import numpy as np

from . import alphabet
from .sequence import Sequence

IUPAC_OPTIMISTIC = "optimistic"
IUPAC_PESSIMISTIC = "pessimistic"
IUPAC_EXACT = "exact"

DIST_NONE = "none"
DIST_JC = "jc"

COVER_ABS = "abs"
COVER_QUERY = "query"
COVER_TARGET = "target"
COVER_OVERLAP = "overlap"
COVER_ALL = "all"
COVER_AVERAGE = "average"
COVER_MIN = "min"
COVER_MAX = "max"
COVER_NOGAP = "nogap"

_IUPAC_FN = {
    IUPAC_OPTIMISTIC: alphabet.comp_optimistic,
    IUPAC_PESSIMISTIC: alphabet.comp_pessimistic,
    IUPAC_EXACT: alphabet.comp_exact,
}


def jukes_cantor(x: float) -> float:
    return -3.0 / 4 * np.log(1.0 - 4.0 / 3 * x)


class Comparator:
    def __init__(
        self,
        iupac: str = IUPAC_OPTIMISTIC,
        dist: str = DIST_NONE,
        cover: str = COVER_QUERY,
        filter_lc: bool = False,
    ):
        if iupac not in _IUPAC_FN:
            raise ValueError(f"unknown iupac rule {iupac}")
        self.iupac = iupac
        self.dist = dist
        self.cover = cover
        self.filter_lc = filter_lc

    def _prep(self, s: Sequence):
        pos, mask = s.positions, s.masks
        if self.filter_lc:
            keep = (mask & alphabet.M_LC) == 0
            pos, mask = pos[keep], mask[keep]
        return pos.astype(np.int64), mask

    def counts(self, a: Sequence, b: Sequence) -> dict:
        apos, amask = self._prep(a)
        bpos, bmask = self._prep(b)
        out = dict(
            match=0, mismatch=0, only_a=0, only_b=0,
            only_a_overhang=0, only_b_overhang=0,
        )
        if len(apos) == 0 or len(bpos) == 0:
            out["only_a_overhang"] = len(apos)
            out["only_b_overhang"] = len(bpos)
            return out
        common, ia, ib = np.intersect1d(
            apos, bpos, assume_unique=True, return_indices=True
        )
        cmp = _IUPAC_FN[self.iupac](amask[ia], bmask[ib])
        out["match"] = int(cmp.sum())
        out["mismatch"] = len(common) - out["match"]

        b_lo, b_hi = bpos[0], bpos[-1]
        a_lo, a_hi = apos[0], apos[-1]
        a_only = np.setdiff1d(apos, common, assume_unique=True)
        b_only = np.setdiff1d(bpos, common, assume_unique=True)
        a_over = ((a_only < b_lo) | (a_only > b_hi)).sum()
        b_over = ((b_only < a_lo) | (b_only > a_hi)).sum()
        out["only_a_overhang"] = int(a_over)
        out["only_b_overhang"] = int(b_over)
        out["only_a"] = int(len(a_only) - a_over)
        out["only_b"] = int(len(b_only) - b_over)
        return out

    def _scores_from_counts(
        self, nat: np.ndarray, qpos: np.ndarray, nq: int
    ) -> np.ndarray:
        """Counts (n, 6) [match, common, nb, b_in, r_lo, r_hi] from
        the native traversal -> cover-normalised (optionally JC)
        scores, vectorised."""
        n = len(nat)
        match = nat[:, 0].astype(np.float64)
        common = nat[:, 1]
        nb = nat[:, 2]
        b_in = nat[:, 3]
        r_lo, r_hi = nat[:, 4], nat[:, 5]
        mm = common  # match + mismatch
        only_b = b_in - common
        b_over = nb - b_in
        a_in = np.searchsorted(
            qpos, r_hi, side="right"
        ) - np.searchsorted(qpos, r_lo, side="left")
        only_a = a_in - common
        a_over = nq - a_in
        cover = self.cover
        if cover == COVER_ABS:
            base = np.ones(n, dtype=np.int64)
        elif cover == COVER_QUERY:
            base = mm + only_a + a_over
        elif cover == COVER_TARGET:
            base = mm + only_b + b_over
        elif cover == COVER_OVERLAP:
            base = mm + only_a + only_b
        elif cover == COVER_ALL:
            base = mm + only_a + only_b + a_over + b_over
        elif cover == COVER_AVERAGE:
            base = mm + (
                only_a + only_b + a_over + b_over
            ) // 2
        elif cover == COVER_MIN:
            base = mm + np.minimum(
                only_a + a_over, only_b + b_over
            )
        elif cover == COVER_MAX:
            base = mm + np.maximum(
                only_a + a_over, only_b + b_over
            )
        else:  # nogap
            base = mm
        dist = np.where(
            base > 0, match / np.maximum(base, 1), 0.0
        )
        if self.dist == DIST_JC:
            with np.errstate(invalid="ignore", divide="ignore"):
                dist = jukes_cantor(dist)
        return np.where(nb > 0, dist, 0.0)

    def score_many_batch(
        self,
        queries: list[Sequence],
        flat_pos: np.ndarray,
        flat_masks: np.ndarray,
        offsets: np.ndarray,
        ids_list: list[np.ndarray],
        width: int,
    ) -> list[np.ndarray]:
        """score_many for a whole batch in ONE native call (threaded
        over queries) — the search stage's candidate rescoring
        (search_filter.cpp:243-416) was per-query and
        single-threaded.  Falls back to per-query score_many."""
        from . import native

        B = len(queries)
        preps = [self._prep(q) for q in queries]
        qcol = np.zeros((B, width + 1), dtype=np.uint8)
        q_lo = np.zeros(B, dtype=np.int64)
        q_hi = np.zeros(B, dtype=np.int64)
        for b, (qpos, qmask) in enumerate(preps):
            if len(qpos):
                qcol[b, qpos] = qmask
                q_lo[b], q_hi[b] = int(qpos[0]), int(qpos[-1])
        id_offsets = np.zeros(B + 1, dtype=np.int64)
        np.cumsum([len(i) for i in ids_list], out=id_offsets[1:])
        flat_ids = (
            np.concatenate(ids_list).astype(np.int64)
            if B
            else np.zeros(0, np.int64)
        )
        rule_id = {
            IUPAC_OPTIMISTIC: 0,
            IUPAC_PESSIMISTIC: 1,
            IUPAC_EXACT: 2,
        }[self.iupac]
        nat = native.score_counts_mq(
            flat_pos, flat_masks, offsets, flat_ids, id_offsets,
            qcol, q_lo, q_hi, rule_id, self.filter_lc,
        )
        if nat is None:
            return [
                self.score_many(
                    q, flat_pos, flat_masks, offsets, ids, width
                )
                for q, ids in zip(queries, ids_list)
            ]
        out = []
        for b in range(B):
            lo, hi = int(id_offsets[b]), int(id_offsets[b + 1])
            qpos = preps[b][0]
            if len(qpos) == 0:
                out.append(np.zeros(hi - lo, dtype=np.float64))
                continue
            out.append(
                self._scores_from_counts(
                    nat[lo:hi], qpos, len(qpos)
                )
            )
        return out

    def score_many(
        self,
        query: Sequence,
        flat_pos: np.ndarray,
        flat_masks: np.ndarray,
        offsets: np.ndarray,
        ids: np.ndarray,
        width: int,
    ) -> np.ndarray:
        """Score one query against many references at once.  The
        references are given as packed arrays (ReferenceDb.
        packed_arrays); `ids` selects which.  Exact same counts as
        `counts()`, vectorised with segment reductions."""
        qpos, qmask = self._prep(query)
        n = len(ids)
        if len(qpos) == 0:
            return np.zeros(n, dtype=np.float64)
        qcol_mask = np.zeros(width + 1, dtype=np.uint8)
        qcol_mask[qpos] = qmask
        q_lo, q_hi = int(qpos[0]), int(qpos[-1])
        nq = len(qpos)

        lc = self.filter_lc
        from . import native

        rule_id = {
            IUPAC_OPTIMISTIC: 0,
            IUPAC_PESSIMISTIC: 1,
            IUPAC_EXACT: 2,
        }[self.iupac]
        nat = native.score_counts(
            flat_pos, flat_masks, offsets,
            np.asarray(ids, dtype=np.int64), qcol_mask,
            q_lo, q_hi, rule_id, lc,
        )
        if nat is not None:
            return self._scores_from_counts(nat, qpos, nq)

        cmp_fn = _IUPAC_FN[self.iupac]
        out = np.zeros(n, dtype=np.float64)
        for k in range(n):
            r = int(ids[k])
            lo, hi = int(offsets[r]), int(offsets[r + 1])
            rpos = flat_pos[lo:hi].astype(np.int64)
            rmask = flat_masks[lo:hi]
            if lc:
                keep = (rmask & alphabet.M_LC) == 0
                rpos, rmask = rpos[keep], rmask[keep]
            if len(rpos) == 0:
                continue
            qm = qcol_mask[rpos]
            shared = qm != 0
            match = int(cmp_fn(qm[shared], rmask[shared]).sum())
            common = int(shared.sum())
            mismatch = common - match
            nb = len(rpos)
            r_lo, r_hi = int(rpos[0]), int(rpos[-1])
            # ref bases inside the query's span
            b_in = int(
                np.searchsorted(rpos, q_hi, side="right")
                - np.searchsorted(rpos, q_lo, side="left")
            )
            only_b = b_in - common
            b_over = nb - b_in
            # query bases inside the ref's span
            a_in = int(
                np.searchsorted(qpos, r_hi, side="right")
                - np.searchsorted(qpos, r_lo, side="left")
            )
            only_a = a_in - common
            a_over = nq - a_in
            mm = match + mismatch
            cover = self.cover
            if cover == COVER_ABS:
                base = 1
            elif cover == COVER_QUERY:
                base = mm + only_a + a_over
            elif cover == COVER_TARGET:
                base = mm + only_b + b_over
            elif cover == COVER_OVERLAP:
                base = mm + only_a + only_b
            elif cover == COVER_ALL:
                base = mm + only_a + only_b + a_over + b_over
            elif cover == COVER_AVERAGE:
                base = mm + (only_a + only_b + a_over + b_over) // 2
            elif cover == COVER_MIN:
                base = mm + min(only_a + a_over, only_b + b_over)
            elif cover == COVER_MAX:
                base = mm + max(only_a + a_over, only_b + b_over)
            else:  # nogap
                base = mm
            dist = match / base if base else 0.0
            if self.dist == DIST_JC:
                dist = jukes_cantor(dist)
            out[k] = dist
        return out

    def __call__(self, a: Sequence, b: Sequence) -> float:
        m = self.counts(a, b)
        mm = m["match"] + m["mismatch"]
        cover = self.cover
        if cover == COVER_ABS:
            base = 1
        elif cover == COVER_QUERY:
            base = mm + m["only_a"] + m["only_a_overhang"]
        elif cover == COVER_TARGET:
            base = mm + m["only_b"] + m["only_b_overhang"]
        elif cover == COVER_OVERLAP:
            base = mm + m["only_a"] + m["only_b"]
        elif cover == COVER_ALL:
            base = (
                mm + m["only_a"] + m["only_b"]
                + m["only_a_overhang"] + m["only_b_overhang"]
            )
        elif cover == COVER_AVERAGE:
            base = mm + (
                m["only_a"] + m["only_b"]
                + m["only_a_overhang"] + m["only_b_overhang"]
            ) // 2
        elif cover == COVER_MIN:
            base = mm + min(
                m["only_a"] + m["only_a_overhang"],
                m["only_b"] + m["only_b_overhang"],
            )
        elif cover == COVER_MAX:
            base = mm + max(
                m["only_a"] + m["only_a_overhang"],
                m["only_b"] + m["only_b_overhang"],
            )
        elif cover == COVER_NOGAP:
            base = mm
        else:
            raise ValueError(f"unknown cover rule {self.cover}")
        dist = m["match"] / base if base else 0.0
        if self.dist == DIST_JC:
            dist = jukes_cantor(dist)
        return float(dist)
