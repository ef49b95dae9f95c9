"""Reference (family) selection stage.

Port of sina_tpu/famfinder.py: orientation ("turn") check via 4-way
index probing, constraint-driven family selection with escalating
retry, gap-count filtering and alignment-stats selection.  Scoring and
top-k run batched on the torch device (ops/kmer_kernel); the policy
layer is host-side python over small top-k lists, copied from the
reference without change.  With more than one CUDA device (or a mesh
given), the index is sharded over a (dp, mp) device mesh as the JAX
package shards it over its devices (parallel/sharding.py).
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from .comparator import Comparator, IUPAC_OPTIMISTIC, COVER_QUERY
from .ops.kmer import query_kmers_padded
from .ops.kmer_index import KmerIndex, device_matrix
from .refdb import ReferenceDb
from .sequence import Sequence
from .timing import get_timer
from .ops import transfer
from .ops.kmer_kernel import kmer_scores, score_topk as _score_topk_device
from .ops.profile import _bucket_rows
from .parallel.multihost import process_count
from .parallel.sharding import (
    Mesh, ShardedMatrix, make_mesh, shard_index_matrix, sharded_scores, sharded_search,
)

logger = logging.getLogger("sina.famfinder")

TURN_NONE = "none"
TURN_REVCOMP = "revcomp"
TURN_ALL = "all"
# turn_slv by orientation: 0 as is, 1 reversed, 2 complemented, 3 both
TURN_NAMES = ("none", "reversed", "complemented", "reversed and complemented")


def _orientations(query: Sequence, all4: bool) -> list[np.ndarray]:
    """The query's masks in the orientations the turn check scores, in
    the reference's order: as is and reversed and complemented, or all
    four (famfinder.cpp:344-378)."""
    out = [query.masks]
    if all4:
        out += [query.copy().reverse().masks, query.copy().complement().masks]
    out.append(query.copy().reverse().complement().masks)
    return out


def _pick_orientation(tops, all4: bool) -> int:
    """The orientation (0-3) whose top-1 score is highest: a strict `>`
    in the reference's order, so a tie keeps the earlier one."""
    best, best_score = 0, 0.0
    for top, oi in zip(tops, (0, 1, 2, 3) if all4 else (0, 3)):
        if top > best_score:
            best_score, best = float(top), oi
    return best


def _turn(query: Sequence, which: int) -> None:
    """Record orientation `which` in turn_slv and turn the query to it."""
    query.set_attr("turn_slv", TURN_NAMES[which])
    if which in (1, 3):
        query.reverse()
    if which in (2, 3):
        query.complement()


@dataclass
class FamFinderConfig:
    turn: str = TURN_NONE
    fs_kmer_len: int = 10
    fs_no_fast: bool = False
    fs_min: int = 40
    fs_max: int = 40
    fs_msc: float = 0.7
    fs_msc_max: float = 2.0
    fs_leave_query_out: bool = False
    fs_req: int = 1
    fs_req_full: int = 1
    fs_full_len: int = 1400
    fs_req_gaps: int = 10
    fs_min_len: int = 150
    fs_cover_gene: int = 0
    gene_start: int = 0
    gene_end: int = 0
    posvar_filter: str = ""
    posvar_autofilter_field: str = ""
    posvar_autofilter_thres: float = 0.8


@dataclass
class FamilyResult:
    family: list[tuple[float, Sequence]]
    astats_name: str = ""
    astats_weights: np.ndarray | None = None
    log: list[str] = field(default_factory=list)
    failed: bool = False


class FamFinder:
    def __init__(self, db: ReferenceDb, cfg: FamFinderConfig | None = None,
                 device: torch.device | str = "cuda", mesh: Mesh | None = None):
        """`mesh` shards the index over its devices.  Without one, a
        finder on CUDA builds one over every visible CUDA device when
        there are several, as the JAX package does over its devices
        (sina_tpu/famfinder.py:111-133): under a multi-process run each
        process's own devices, all of them index shards (dp = 1)."""
        self.db = db
        self.cfg = cfg or FamFinderConfig()
        self.device = torch.device(device)
        db.ensure_flat()  # batch profile build gathers flat arrays
        self.index = KmerIndex.build(
            db, k=self.cfg.fs_kmer_len, fast=not self.cfg.fs_no_fast
        )
        if mesh is None and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            mesh = make_mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())],
                             dp=1 if process_count() > 1 else None)
        self.mesh = mesh
        self._P = None

    def on_device(self, device: torch.device | str) -> "FamFinder":
        """A finder on `device` that shares this one's database and
        k-mer index (the index build is the expensive part of set-up),
        and its device matrix when `device` is its own.  A finder on a
        mesh gets a mesh of the same (dp, mp) over `device`, so that a
        run there compares like with like."""
        other = copy.copy(self)
        other.device = torch.device(device)
        if other.device != self.device:
            other._P = None
            if self.mesh is not None:
                dp, mp = self.mesh.shape["dp"], self.mesh.shape["mp"]
                other.mesh = make_mesh([other.device] * (dp * mp), dp=dp)
        return other

    # -- device scoring ----------------------------------------------

    def _matrix(self) -> torch.Tensor | ShardedMatrix:
        if self._P is None:
            if self.mesh is None:
                self._P = device_matrix(self.index, self.device)
                return self._P
            mp = self.mesh.shape["mp"]
            cap = -(-max(self.index.n_seqs, 1) // 1024) * 1024
            if cap >= 32768:
                # SILVA scale: per-shard exact-size tiled blocks (the
                # single-device layout, sharded over the lane axis)
                P = self.index.dense_packed_tiled(byte_multiple=4096 * mp)
            else:
                # the byte axis padded to whole 4-byte words a shard
                # (the scorer kernel copies 4-byte words; the JAX
                # package pads to mp).  The ids are the same: each
                # shard holds a contiguous id range ranked lowest id
                # first, and padding ranks after every reference
                P = self.index.dense_packed()
                Sb = P.shape[1]
                Sb_pad = -(-Sb // (4 * mp)) * (4 * mp)
                if Sb_pad != Sb:
                    P = np.pad(P, ((0, 0), (0, Sb_pad - Sb)))
            # slice on the host: the whole matrix never sits on one device
            self._P = shard_index_matrix(self.mesh, P)
        return self._P

    def _pad_dp(self, kmers: np.ndarray) -> np.ndarray:
        """A row-bucketed batch padded to a multiple of the mesh's dp
        with the sink row, for the mesh split
        (sina_tpu/famfinder.py:214-226)."""
        dp = self.mesh.shape["dp"]
        B_pad = -(-kmers.shape[0] // dp) * dp
        if B_pad == kmers.shape[0]:
            return kmers
        return np.pad(kmers, ((0, B_pad - kmers.shape[0]), (0, 0)),
                      constant_values=self._matrix().shape[0] - 1)

    def _sharded_topk(self, kmers: np.ndarray, k: int) -> torch.Tensor:
        """The mesh's scoring + top-k of a row-bucketed batch, packed
        as score_topk packs it: (B_pad, 2k) int32 [values | ids] on the
        merge device, not fetched."""
        vals, ids = sharded_search(self.mesh, k)(self._matrix(), self._pad_dp(kmers))
        return torch.cat([vals, ids], dim=1)

    @staticmethod
    def _pad_rows(kmers: np.ndarray, sink: int) -> np.ndarray:
        """Pad the batch axis to a row bucket
        (sina_tpu/famfinder.py:158-172).  Padded rows point every k-mer
        at the sink row, scoring 0 everywhere."""
        B = kmers.shape[0]
        B_pad = _bucket_rows(B)
        if B_pad == B:
            return kmers
        return np.pad(
            kmers, ((0, B_pad - B), (0, 0)), constant_values=sink
        )

    def _upload(self, kmers: np.ndarray) -> torch.Tensor:
        return transfer.upload(kmers, self.device)

    def score_batch(self, mask_list: list[np.ndarray]) -> np.ndarray:
        """Raw k-mer hit counts (B, n_seqs) for a batch of queries."""
        t = get_timer("Kmer Search")
        with t.section("extract kmers"):
            kmers, _ = query_kmers_padded(
                mask_list, self.index.k, fast=self.index.fast
            )
        with t.section("score+fetch"):
            B = kmers.shape[0]
            kmers = self._pad_rows(
                kmers, self._matrix().shape[0] - 1
            )
            if self.mesh is not None:
                scores = sharded_scores(self.mesh, self._matrix(), self._pad_dp(kmers))
            else:
                scores = kmer_scores(self._matrix(), self._upload(kmers))
            scores = scores.cpu().numpy()
            return scores[:B, : self.index.n_seqs]

    def score_topk(
        self, mask_list: list[np.ndarray], k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Device-side scoring + top-k: only the (B, k) candidate
        lists cross to the host.  Ties resolve as in the JAX package
        (ops/kmer_kernel.score_topk: the lowest id, and by group rank
        at the k-th value from 32,768 padded references on; a
        deviation from kmer_search.cpp:412, which prefers the
        highest)."""
        t = get_timer("Kmer Search")
        with t.section("extract kmers"):
            kmers, _ = query_kmers_padded(
                mask_list, self.index.k, fast=self.index.fast
            )
        k = min(k, self.index.n_seqs)
        with t.section("score+topk"):
            P = self._matrix()
            B = kmers.shape[0]
            # row-bucket first, then (on a mesh) pad to a dp multiple
            kmers = self._pad_rows(kmers, P.shape[0] - 1)
            if self.mesh is not None:
                packed = self._sharded_topk(kmers, k)
            else:
                packed = _score_topk_device(P, self._upload(kmers), k)
            # the turn check and the escalation wait for their scores
            # at once (sina_tpu/famfinder.py:625-626)
            packed = packed.cpu().numpy()
            vals, ids = packed[:B, :k], packed[:B, k:]
            pad = ids >= self.index.n_seqs
            vals = np.where(pad, -1, vals)
            ids = np.where(pad, 0, ids)
            return vals, ids

    def _seq_stats(self):
        """Per-sequence (lengths, first position, last position)
        arrays over the whole db — the vectorized _filter's inputs."""
        if getattr(self, "_stats", None) is None:
            offsets, flat_pos, _ = self.db.flat_arrays()
            lens = np.diff(offsets)
            n = len(lens)
            pos0 = np.zeros(n, np.int64)
            posN = np.full(n, -1, np.int64)
            nz = lens > 0
            pos0[nz] = flat_pos[offsets[:-1][nz]]
            posN[nz] = flat_pos[(offsets[1:] - 1)[nz]]
            self._stats = (lens, pos0, posN)
        return self._stats

    def _filter_fast(self, vals, ids, limit: int):
        """Vectorized _filter (famfinder.cpp:541-588 semantics;
        sina_tpu/famfinder.py:264-333) for configs where no
        per-candidate Sequence object is needed.  Returns (kept
        [(score, seq_id)], have, have_full, cover_l, cover_r)."""
        cfg = self.cfg
        lens, pos0, posN = self._seq_stats()
        # drop invalid (-1 padding) BEFORE the limit slice, like the
        # object path's ranked-list construction: padding rows can
        # interleave with real zero-score candidates at the tie floor
        valid = vals >= 0
        if not valid.all():
            vals = vals[valid]
            ids = ids[valid]
        vals = vals[:limit]
        ids = ids[:limit]
        l = lens[ids]
        keepable = l >= cfg.fs_min_len
        is_full = l >= cfg.fs_full_len
        nz = l > 0
        covers_l = nz & (pos0[ids] <= cfg.gene_start)
        covers_r = nz & (posN[ids] >= cfg.gene_end)
        kept: list[tuple[float, int]] = []
        have = have_full = cover_l = cover_r = 0
        rows = zip(
            vals.tolist(), ids.tolist(), keepable.tolist(),
            is_full.tolist(), covers_l.tolist(), covers_r.tolist(),
        )
        for score, sid, ok, full, cl, cr in rows:
            if not ok:
                continue
            if have >= cfg.fs_min:
                score_keeps = score < cfg.fs_msc
                fills_full = (
                    cfg.fs_req_full
                    and have_full < cfg.fs_req_full
                    and full
                )
                fills_range = cfg.fs_cover_gene and (
                    (cover_r < cfg.fs_cover_gene and cr)
                    or (cover_l < cfg.fs_cover_gene and cl)
                )
                if (
                    (have >= cfg.fs_max or not score_keeps)
                    and not fills_full
                    and not fills_range
                ):
                    if (
                        have >= cfg.fs_max
                        and have_full >= cfg.fs_req_full
                        and cover_l >= cfg.fs_cover_gene
                        and cover_r >= cfg.fs_cover_gene
                    ):
                        break  # no later candidate can be kept
                    continue
            have += 1
            if full:
                have_full += 1
            if cl:
                cover_l += 1
            if cr:
                cover_r += 1
            kept.append((score, sid))
        return kept, have, have_full, cover_l, cover_r

    def _match_fast(
        self, vals: np.ndarray, ids: np.ndarray
    ) -> list[tuple[float, Sequence]] | None:
        """match() over numpy top-k rows (the batched path).  Returns
        None when the candidate rows ran out (the caller refetches
        deeper or defers to the batched escalation)."""
        cfg = self.cfg
        n = self.index.n_seqs
        avail = int((vals >= 0).sum())
        max_results = cfg.fs_max + 1
        while True:
            if avail < min(max_results, n):
                return None  # caller escalates with a deeper top-k
            kept, have, have_full, cl, cr = self._filter_fast(
                vals, ids, max_results
            )
            if (
                have >= cfg.fs_max
                and have_full >= cfg.fs_req_full
                and cl >= cfg.fs_cover_gene
                and cr >= cfg.fs_cover_gene
            ):
                break
            if max_results >= n:
                break
            max_results *= 10
        seqs = self.db.sequences
        return [(score, seqs[sid]) for score, sid in kept]

    def _fast_policy_ok(self) -> bool:
        """The vectorized filter applies when no per-candidate
        Sequence object is consulted: leave-query-out needs names,
        an active fs_msc_max (< 1.0) needs the comparator."""
        return (
            not self.cfg.fs_leave_query_out
            and self.cfg.fs_msc_max >= 1.0
        )

    def find(
        self, query: Sequence, max_results: int
    ) -> list[tuple[float, int]]:
        """Ranked [(score, seq_id)] for one query
        (kmer_search.cpp:366-420)."""
        scores = self.score_batch([query.masks])[0]
        return self._rank(scores, max_results)

    def _rank(self, scores: np.ndarray, max_results: int):
        max_results = min(max_results, len(scores))
        # descending score; reference breaks ties by higher id
        # (std::greater on (score,id) pairs, kmer_search.cpp:412)
        order = np.lexsort((-np.arange(len(scores)), -scores))
        top = order[:max_results]
        return [(float(scores[i]), int(i)) for i in top]

    # -- turn check ---------------------------------------------------

    def turn_check(self, query: Sequence, all4: bool) -> int:
        """0=asis 1=reversed 2=complemented 3=revcomp
        (famfinder.cpp:344-378)."""
        scores = self.score_batch(_orientations(query, all4))
        return _pick_orientation(scores.max(axis=1), all4)

    def apply_turn(self, query: Sequence) -> Sequence:
        if self.cfg.turn == TURN_NONE:
            query.set_attr("turn_slv", "turn-check disabled")
        else:
            _turn(query, self.turn_check(query, self.cfg.turn == TURN_ALL))
        return query

    # -- family selection policy --------------------------------------

    def match(
        self,
        query: Sequence,
        scores: np.ndarray | None = None,
        ranked: list[tuple[float, int]] | None = None,
        allow_refetch: bool = True,
    ) -> list[tuple[float, Sequence]] | None:
        """Constraint-driven family selection (famfinder.cpp:497-612;
        sina_tpu/famfinder.py:436-479)."""
        cfg = self.cfg
        cmp = Comparator(IUPAC_OPTIMISTIC, "none", COVER_QUERY, False)
        qbases = query.get_bases().upper().replace("U", "T")

        max_results = cfg.fs_max + 1
        n = self.index.n_seqs
        while True:
            if ranked is not None and len(ranked) >= min(
                max_results, n
            ):
                cand = ranked[:max_results]
            else:
                if scores is None:
                    if not allow_refetch:
                        return None
                    scores = self.score_batch([query.masks])[0]
                cand = self._rank(scores, max_results)
                ranked = None
            kept = self._filter(cand, query, qbases, cmp)
            have, have_full, cl, cr = self._tally(kept)
            if (
                have >= cfg.fs_max
                and have_full >= cfg.fs_req_full
                and cl >= cfg.fs_cover_gene
                and cr >= cfg.fs_cover_gene
            ):
                break
            if max_results >= n:
                break
            max_results *= 10
        return kept

    def _is_full(self, seq: Sequence) -> bool:
        return len(seq) >= self.cfg.fs_full_len

    def _covers_left(self, seq: Sequence) -> bool:
        return (
            len(seq) > 0
            and int(seq.positions[0]) <= self.cfg.gene_start
        )

    def _covers_right(self, seq: Sequence) -> bool:
        return (
            len(seq) > 0
            and int(seq.positions[-1]) >= self.cfg.gene_end
        )

    def _tally(self, kept):
        have = len(kept)
        have_full = sum(1 for _, s in kept if self._is_full(s))
        cl = sum(1 for _, s in kept if self._covers_left(s))
        cr = sum(1 for _, s in kept if self._covers_right(s))
        return have, have_full, cl, cr

    def _filter(self, ranked, query, qbases, cmp):
        cfg = self.cfg
        kept: list[tuple[float, Sequence]] = []
        have = have_full = cover_l = cover_r = 0
        for score, sid in ranked:
            seq = self.db.sequences[sid]
            if len(seq) < cfg.fs_min_len:
                continue
            if cfg.fs_leave_query_out and seq.name == query.name:
                continue
            # the reference evaluates the comparator whenever
            # max_score <= 2 (famfinder.cpp:555), but identities are
            # <= 1, so thresholds above 1 can never remove anything —
            # skip the (expensive) comparison then
            if cfg.fs_msc_max < 1.0 and (
                cmp(query, seq) > cfg.fs_msc_max
            ):
                continue
            # beyond fs-min, the reference keeps only items whose score
            # is below fs-msc plus quota-fillers (famfinder.cpp:578-588;
            # reproduced as written — inert at default fs-min == fs-max)
            if have >= cfg.fs_min:
                score_keeps = score < cfg.fs_msc
                fills_full = (
                    cfg.fs_req_full
                    and have_full < cfg.fs_req_full
                    and self._is_full(seq)
                )
                fills_range = cfg.fs_cover_gene and (
                    (cover_r < cfg.fs_cover_gene and self._covers_right(seq))
                    or (cover_l < cfg.fs_cover_gene and self._covers_left(seq))
                )
                if (
                    (have >= cfg.fs_max or not score_keeps)
                    and not fills_full
                    and not fills_range
                ):
                    continue
            have += 1
            if self._is_full(seq):
                have_full += 1
            if self._covers_left(seq):
                cover_l += 1
            if self._covers_right(seq):
                cover_r += 1
            kept.append((score, seq))
        return kept

    # -- astats selection ---------------------------------------------

    def select_astats(
        self, family: list[tuple[float, Sequence]]
    ) -> tuple[str, np.ndarray | None, list[str]]:
        """Filter/quorum-vote alignment-stats selection
        (famfinder.cpp:381-436).  Returns (name, weights, log)."""
        from .stats import compute_weights

        cfg = self.cfg
        log: list[str] = []
        chosen = None
        if cfg.posvar_filter:
            for a in self.db.astats:
                if a["name"] in (
                    cfg.posvar_filter,
                    cfg.posvar_filter + ":ALL",
                    cfg.posvar_filter + ":all",
                ):
                    chosen = a
        if cfg.posvar_autofilter_field:
            best, best_count = None, 0
            for a in self.db.astats:
                n = 0
                for _, r in family:
                    f = (
                        cfg.posvar_filter
                        + ":"
                        + str(r.get_attr(cfg.posvar_autofilter_field, ""))
                    )
                    if f.lower().startswith(a["name"].lower()):
                        n += 1
                if n > best_count:
                    best, best_count = a, n
            if best is not None and best_count > len(family) * (
                cfg.posvar_autofilter_thres
            ):
                log.append(f"autofilter: {best['name']};")
                chosen = best
            else:
                log.append("autofilter: no match;")
        if chosen is None:
            return "", None, log
        return chosen["name"], compute_weights(chosen), log

    # -- full stage ---------------------------------------------------

    @staticmethod
    def _dedupe_masks(
        mask_list: list[np.ndarray],
    ) -> tuple[list[np.ndarray], np.ndarray]:
        """Collapse base-identical queries to one scoring row each
        (the reference's FIFO result cache keyed on query bases,
        kmer_search.cpp:105,378).  Returns (unique mask list, inverse
        map batch-row -> unique-row)."""
        seen: dict[bytes, int] = {}
        inv = np.empty(len(mask_list), dtype=np.int64)
        uniq: list[np.ndarray] = []
        for i, m in enumerate(mask_list):
            key = m.tobytes()
            j = seen.get(key)
            if j is None:
                j = seen[key] = len(uniq)
                uniq.append(m)
            inv[i] = j
        return uniq, inv

    def submit_batch(self, queries: list[Sequence]):
        """Launch the device scoring + top-k for a batch and start the
        copy of its (B_pad, 2k) result to the host, WITHOUT waiting
        (ops/transfer.fetch_async), so callers overlap it with other
        work; pass the handle to process_batch(queries, handle=...),
        whose fetch waits for this copy only."""
        cfg = self.cfg
        if not queries or cfg.turn != TURN_NONE:
            return None  # turn path fetches eagerly
        t = get_timer("Kmer Search")
        with t.section("extract kmers"):
            uniq, inv = self._dedupe_masks([q.masks for q in queries])
            kmers, _ = query_kmers_padded(
                uniq, self.index.k, fast=self.index.fast,
            )
            P = self._matrix()
            kmers = self._pad_rows(kmers, P.shape[0] - 1)
        k0 = min(
            max(4 * cfg.fs_max + 16, 256), self.index.n_seqs
        )
        with t.section("score dispatch"):
            if self.mesh is not None:
                # the same handle, so the 3-deep pipeline overlaps
                # identically on a mesh
                packed = self._sharded_topk(kmers, k0)
            else:
                packed = _score_topk_device(P, self._upload(kmers), k0)
            fetch = transfer.fetch_async(packed)
        return fetch, k0, inv

    def process_batch(
        self, queries: list[Sequence], handle=None
    ) -> list[FamilyResult]:
        """Batched famfinder: one device call scores every query; the
        per-query policy runs on the host over the returned top-k
        rows."""
        cfg = self.cfg
        B = len(queries)
        if B == 0:
            return []
        if handle is not None:
            fetch, k0, inv = handle
            t = get_timer("Kmer Search")
            with t.section("fetch topk"):
                packed = fetch.result()
                vals, ids = packed[:, :k0], packed[:, k0:]
            with t.section("policy"):
                pad = ids >= self.index.n_seqs
                vals = np.where(pad, -1, vals)
                ids = np.where(pad, 0, ids)
                out = []
                for b, q in enumerate(queries):
                    q.set_attr("turn_slv", "turn-check disabled")
                    u = int(inv[b])
                    out.append(
                        self._finish(
                            q, ranked_np=(vals[u], ids[u]),
                            allow_refetch=False,
                        )
                    )
                self._finish_escalated(queries, out)
            return out
        inv = None
        all4 = cfg.turn == TURN_ALL
        if cfg.turn == TURN_NONE:
            for q in queries:
                q.set_attr("turn_slv", "turn-check disabled")
            variants_per = 1
            mask_list, inv = self._dedupe_masks(
                [q.masks for q in queries]
            )
        else:
            # every orientation of every query in one scoring call
            variants_per = 4 if all4 else 2
            mask_list = [m for q in queries for m in _orientations(q, all4)]
        k0 = min(
            max(4 * cfg.fs_max + 16, 256), self.index.n_seqs
        )
        vals, ids = self.score_topk(mask_list, k0)

        out: list[FamilyResult | None] = [None] * B
        reoriented: list[tuple[int, Sequence]] = []
        for b, q in enumerate(queries):
            row = int(inv[b]) if inv is not None else b * variants_per
            if cfg.turn != TURN_NONE:
                best = _pick_orientation(
                    vals[row : row + variants_per, 0], all4
                )
                _turn(q, best)
                if best != 0:
                    # orientation changed: rescore, batched with the
                    # other reoriented queries below (one device call
                    # for all of them)
                    reoriented.append((b, q))
                    continue
            out[b] = self._finish(
                q, ranked_np=(vals[row], ids[row]),
                allow_refetch=False,
            )
        if reoriented:
            v1, i1 = self.score_topk(
                [q.masks for _, q in reoriented], k0
            )
            for row, (b, q) in enumerate(reoriented):
                out[b] = self._finish(
                    q, ranked_np=(v1[row], i1[row]),
                    allow_refetch=False,
                )
        self._finish_escalated(queries, out)
        return out

    def _finish_escalated(self, queries, out) -> None:
        """Batched constraint-escalation refetch
        (famfinder.cpp:591-608's x10 retry): queries whose candidate
        list ran out are re-scored together at an escalating device
        top-k (x10 per rung)."""
        todo = [b for b, r in enumerate(out) if r is None]
        if not todo:
            return
        n = self.index.n_seqs
        k = min(
            max(4 * self.cfg.fs_max + 16, 256) * 10, n
        )
        while todo:
            uniq, einv = self._dedupe_masks(
                [queries[b].masks for b in todo]
            )
            vals, ids = self.score_topk(uniq, k)
            still: list[int] = []
            for row, b in enumerate(todo):
                u = int(einv[row])
                res = self._finish(
                    queries[b], ranked_np=(vals[u], ids[u]),
                    allow_refetch=(k >= n),
                )
                if res is None:
                    still.append(b)
                else:
                    out[b] = res
            todo = still
            if k >= n:
                break
            k = min(k * 10, n)

    def __call__(self, query: Sequence) -> FamilyResult:
        self.apply_turn(query)
        return self._finish(query)

    def _finish(
        self,
        query: Sequence,
        scores: np.ndarray | None = None,
        ranked: list[tuple[float, int]] | None = None,
        allow_refetch: bool = True,
        ranked_np: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> FamilyResult | None:
        """Post-turn-check famfinder stage body
        (famfinder.cpp:439-494; sina_tpu/famfinder.py:814-878).
        Returns None when the candidate list ran out and
        allow_refetch is False."""
        cfg = self.cfg
        if ranked_np is not None and self._fast_policy_ok():
            family = self._match_fast(ranked_np[0], ranked_np[1])
            if family is None:
                if not allow_refetch:
                    return None
                family = self.match(
                    query,
                    ranked=[
                        (float(v), int(i))
                        for v, i in zip(*ranked_np)
                        if v >= 0
                    ],
                    allow_refetch=True,
                )
        else:
            if ranked_np is not None:
                ranked = [
                    (float(v), int(i))
                    for v, i in zip(*ranked_np)
                    if v >= 0
                ]
            family = self.match(
                query, scores=scores, ranked=ranked,
                allow_refetch=allow_refetch,
            )
        if family is None:
            return None

        # family string attr (famfinder.cpp:458-470)
        fam_str = " ".join(
            f"{s.get_attr('acc', s.name)}.{s.get_attr('start', '0')}"
            f":{score:.2f}"
            for score, s in family
        )
        query.set_attr("align_family_slv", fam_str)

        if cfg.fs_req_gaps:
            family = [
                (sc, s)
                for sc, s in family
                if len(s) and s.internal_gaps() >= cfg.fs_req_gaps
            ]
        name, weights, log = self.select_astats(family)
        res = FamilyResult(family, name, weights, log)
        if len(family) < cfg.fs_req:
            res.log.append(
                f"unable to align: too few relatives ({len(family)});"
            )
            res.failed = True
        return res
