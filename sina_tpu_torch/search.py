"""Search & classify stage.

Copy of sina_tpu/search.py, the port of the semantics of search_filter
(SINA src/search_filter.cpp:243-416): retrieve candidates
(k-mer heuristic on the torch device, or brute-force all), re-score
with the MSA-based comparator, threshold + cap, write `nearest_slv`,
copy requested fields and run the LCA taxonomy vote per requested
field.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from .comparator import (
    Comparator,
    IUPAC_OPTIMISTIC,
    DIST_NONE,
    COVER_QUERY,
)
from .famfinder import FamFinder, FamFinderConfig
from .refdb import ReferenceDb
from .sequence import Sequence

logger = logging.getLogger("sina.search")

FN_NEAREST = "nearest_slv"


@dataclass
class SearchConfig:
    min_sim: float = 0.7
    max_result: int = 10
    kmer_candidates: int = 1000
    search_all: bool = False
    ignore_super: bool = False
    lca_fields: list[str] = field(default_factory=list)
    lca_quorum: float = 0.7
    copy_fields: list[str] = field(default_factory=list)
    kmer_len: int = 10
    no_fast: bool = False
    # comparator options (cseq_comparator.cpp:433-482 defaults)
    iupac: str = IUPAC_OPTIMISTIC
    correction: str = DIST_NONE
    cover: str = COVER_QUERY
    filter_lowercase: bool = False


def lca_classify(
    tax_paths: list[list[str]], n_results: int, quorum: float
) -> str:
    """LCA vote over ';'-separated taxonomy paths
    (search_filter.cpp:374-413): accept the deepest prefix shared by
    all paths after discarding at most (1-quorum)*n outliers."""
    groups = [list(reversed(p)) for p in tax_paths]
    outliers = int(n_results * (1 - quorum) + 0.5)
    result: list[str] = []
    while outliers >= 0 and groups:
        first = groups[0]
        if not first:
            groups.pop(0)
            outliers -= 1
            continue
        name = first[-1]
        mismatch = next(
            (
                gi
                for gi, g in enumerate(groups[1:], 1)
                if not g or g[-1] != name
            ),
            None,
        )
        if mismatch is not None:
            groups.pop(mismatch)
            outliers -= 1
            continue
        for g in groups:
            g.pop()
        result.append(name)
    res = ";".join(result) + ";" if result else ""
    if not res or res == ";":
        return "Unclassified;"
    return res


class SearchFilter:
    def __init__(
        self,
        db: ReferenceDb,
        cfg: SearchConfig | None = None,
        finder: FamFinder | None = None,
        device=None,
    ):
        """`device` places a finder this filter builds for itself
        (another database or k-mer parameters); by default the shared
        finder's device, else "cuda"."""
        self.db = db
        self.cfg = cfg or SearchConfig()
        c = self.cfg
        self.comparator = Comparator(
            c.iupac, c.correction, c.cover, c.filter_lowercase
        )
        if c.search_all:
            self.finder = None
        elif (
            finder is not None
            and finder.db is db
            and finder.index.k == c.kmer_len
            and finder.index.fast == (not c.no_fast)
        ):
            # same db and same index parameters: share the index
            # (the reference builds a second kmer_search keyed by
            # (db, k, fast) which dedupes identically)
            self.finder = finder
        else:
            if device is None:
                device = finder.device if finder is not None else "cuda"
            self.finder = FamFinder(
                db,
                FamFinderConfig(
                    fs_kmer_len=c.kmer_len, fs_no_fast=c.no_fast
                ),
                device,
            )

    def _contains_query(self, ref: Sequence, q: Sequence) -> bool:
        """Containment with IUPAC-aware base equality
        (search_filter.cpp:225-230: boost contains over bases with
        aligned_base::comp)."""
        from numpy.lib.stride_tricks import sliding_window_view

        rm = ref.masks & 0xF
        qm = q.masks & 0xF
        m = len(qm)
        if m == 0 or len(rm) < m:
            return False
        windows = sliding_window_view(rm, m)        # (n-m+1, m)
        return bool(((windows & qm[None, :]) != 0).all(axis=1).any())

    def _packed(self):
        if not hasattr(self, "_packed_arrays"):
            self._packed_arrays = self.db.packed_arrays()
        return self._packed_arrays

    def process_batch(
        self, aligned_list: list[Sequence | None]
    ) -> list[Sequence | None]:
        """Batched search: one device call retrieves candidates for
        the whole batch; comparator rescoring uses the vectorised
        many-vs-one scorer."""
        cfg = self.cfg
        todo = [
            (i, a)
            for i, a in enumerate(aligned_list)
            if a is not None and len(a) >= 20
        ]
        for i, a in enumerate(aligned_list):
            if a is not None and len(a) < 20:
                logger.info(
                    "%s: sequence too short for search (<20 bases)",
                    a.name,
                )
        cand_per: dict[int, np.ndarray] = {}
        if not cfg.search_all and todo and self.finder is not None:
            vals, ids = self.finder.score_topk(
                [a.masks for _, a in todo],
                cfg.kmer_candidates,
            )
            for b, (i, _) in enumerate(todo):
                cand_per[i] = ids[b][vals[b] >= 0]
        out = list(aligned_list)
        if todo:
            # one threaded native call rescans every (query,
            # candidate) pair; the per-query policy below consumes
            # the precomputed scores.  Chunked so --search-all on a
            # SILVA-scale db never materialises the whole
            # batch x database cross product at once (the counts
            # array is 48 B/pair).
            all_ids = [
                cand_per.get(i)
                if cand_per.get(i) is not None
                else np.arange(len(self.db))
                for i, _ in todo
            ]
            offsets, flat_pos, flat_masks = self._packed()
            max_pairs = 8_000_000
            lo = 0
            while lo < len(todo):
                hi, pairs = lo, 0
                while hi < len(todo) and (
                    hi == lo or pairs + len(all_ids[hi]) <= max_pairs
                ):
                    pairs += len(all_ids[hi])
                    hi += 1
                score_rows = self.comparator.score_many_batch(
                    [a for _, a in todo[lo:hi]],
                    flat_pos, flat_masks, offsets,
                    all_ids[lo:hi], self.db.width,
                )
                for (i, a), ids_q, scores in zip(
                    todo[lo:hi], all_ids[lo:hi], score_rows
                ):
                    out[i] = self._search_one(a, ids_q, scores)
                lo = hi
        return out

    def __call__(self, aligned: Sequence | None) -> Sequence | None:
        if aligned is None:
            return None
        return self.process_batch([aligned])[0]

    def _search_one(
        self,
        aligned: Sequence,
        cand_ids: np.ndarray | None,
        scores: np.ndarray | None = None,
    ) -> Sequence:
        cfg = self.cfg
        if len(aligned) < 20:
            return aligned

        if cfg.search_all or cand_ids is None:
            cand_ids = np.arange(len(self.db))

        if scores is None:
            offsets, flat_pos, flat_masks = self._packed()
            scores = self.comparator.score_many(
                aligned, flat_pos, flat_masks, offsets,
                cand_ids, self.db.width,
            )
        order = np.argsort(-scores, kind="stable")
        items = []
        for k in order:
            if len(items) >= cfg.max_result:
                break
            sc = float(scores[k])
            if sc <= cfg.min_sim:
                break
            ref = self.db.sequences[int(cand_ids[k])]
            if cfg.ignore_super and self._contains_query(
                ref, aligned
            ):
                continue
            items.append((sc, ref))

        nearest = []
        tax_by_field: dict[str, list[list[str]]] = {}
        for score, ref in items:
            for f in cfg.lca_fields:
                path = str(ref.get_attr(f, ""))
                if path == "Unclassified;":
                    continue
                parts = [
                    p for p in path.split(";") if p and p != " "
                ]
                tax_by_field.setdefault(f, []).append(parts)
            nearest.append(
                f"{ref.get_attr('acc', ref.name)}."
                f"{ref.get_attr('version', '')}."
                f"{ref.get_attr('start', '')}."
                f"{ref.get_attr('stop', '')}~{score:.3f}"
            )
            acc = str(ref.get_attr("acc", ref.name))
            for f in cfg.copy_fields:
                aligned.set_attr(
                    f"copy_{acc}_{f}", ref.get_attr(f, "")
                )
        aligned.set_attr(FN_NEAREST, " ".join(nearest))

        for f in cfg.lca_fields:
            aligned.set_attr(
                "lca_" + f,
                lca_classify(
                    tax_by_field.get(f, []),
                    len(items),
                    cfg.lca_quorum,
                ),
            )
        aligned.search_result = items  # type: ignore[attr-defined]
        return aligned
