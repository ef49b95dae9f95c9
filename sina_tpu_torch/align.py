"""Aligner stage: NAST alignment of a query against its family.

Port of sina_tpu/align.py: exact/superstring alignment copy (with
native containment), the profile engine (column trimming, shape
buckets and bucket merging, the batched profile DP of ops/profile),
the graph (mseq) engine (per-family POA graphs, the graph DP and its
traceback of ops/graph_kernel, or the dense route of ops/align_kernel
for graphs with far predecessors), and the host NAST finish, with
--insertion forbid on both engines (the profile DP's bounded-insertion
mode on the profile engine) and the --debug-lattice dumps of
debug_dump.  The host logic is copied from the reference as it is
(byte parity of the output depends on it).
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass

import numpy as np
import torch

from . import alphabet, timing
from .cache import IdentityCache
from .comparator import Comparator, IUPAC_OPTIMISTIC, COVER_OVERLAP
from .sequence import Sequence
from .timing import get_timer

from .ops.graph import LinearGraph, build_graph

from .ops import align_kernel as ak
from .ops import kernels, transfer

logger = logging.getLogger("sina.align")

OVERHANG_ATTACH = "attach"
OVERHANG_REMOVE = "remove"

LOWERCASE_NONE = "none"
LOWERCASE_ORIGINAL = "original"
LOWERCASE_UNALIGNED = "unaligned"

INSERTION_SHIFT = "shift"
INSERTION_FORBID = "forbid"
INSERTION_REMOVE = "remove"

# attribute names follow the reference's field contract
# (SINA src/query_arb.cpp:107-126, doc/source/fields.rst)
FN_DATE = "aligned_slv"
FN_QUAL = "align_quality_slv"
FN_HEAD = "align_cutoff_head_slv"
FN_TAIL = "align_cutoff_tail_slv"
FN_FILTER = "align_filter_slv"
FN_IDTY = "align_ident_slv"
FN_USED_RELS = "used_rels"


@dataclass
class AlignerConfig:
    realign: bool = False
    overhang: str = OVERHANG_ATTACH
    lowercase: str = LOWERCASE_NONE
    insertion: str = INSERTION_SHIFT
    fs_weight: float = 1.0
    match_score: float = 2.0
    mismatch_score: float = -1.0
    gap_penalty: float = 5.0
    gap_ext_penalty: float = 2.0
    calc_idty: bool = False
    write_used_rels: bool = False
    fs_no_graph: bool = False
    # experimental substitution-matrix scoring (align.cpp:265-267,
    # scoring_schemes.h:244-311); only meaningful for the graph
    # engine (the reference ignores it under --fs-no-graph)
    use_subst_matrix: bool = False
    # dump each family graph to a .dot file (--debug-graph; the
    # reference's mesh_debug SVG equivalent, mesh_debug.h)
    debug_graph: bool = False
    # "FROM:TO" alignment-column range: dump the full DP lattice of
    # that region per query to lattice_<name>.dot (--debug-lattice;
    # mesh_to_svg, mesh_debug.h:103-193)
    debug_lattice: str = ""
    # "profile" (pseq chain DP, the default here), "graph" (mseq DAG
    # DP, the reference's default), or "auto" (= profile)
    engine: str = "auto"
    # trim the profile-DP lattice to each query's anchored column
    # window (sina_tpu/ops/colspan.py) — a throughput lever for
    # short-read (amplicon) workloads; full-length queries are
    # unaffected.  --no-col-trim disables.
    col_trim: bool = True
    # trim engages only when the family's full occupied-column count
    # is at least this large.  Window anchoring costs host wall and
    # extra shape buckets, so tiny lattices skip it (the threshold is
    # the JAX package's, chosen from its TPU measurements; it is not
    # yet measured for the port).  Tests force the trim path with
    # col_trim_min_cols=0.
    col_trim_min_cols: int = 1024

    def resolved_engine(self) -> str:
        if self.fs_no_graph:
            return "profile"
        if self.use_subst_matrix:
            return "graph"
        if self.engine == "auto":
            return "profile"
        return self.engine

    def dp_params(self) -> ak.DpParams:
        # the reference negates match/mismatch when building the
        # minimising scheme (align.cpp:406-412)
        return ak.DpParams(
            match=-self.match_score,
            mismatch=-self.mismatch_score,
            gap_open=self.gap_penalty,
            gap_ext=self.gap_ext_penalty,
        )


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%d %H:%M:%S"
    )


class AlignmentFailure(Exception):
    pass


# Normalized base-string cache for try_copy_alignment: family members
# are the db's shared Sequence objects repeated across queries and
# batches, so to_chars + upper + replace runs once per member.
_norm_bases_cache = IdentityCache(65536, "norm_bases")  # ~100MB worst case


def _norm_bases(seq: Sequence) -> str:
    return _norm_bases_cache.get(
        seq, lambda s: s.get_bases().upper().replace("U", "T")
    )


def _containment_batch(queries, families):
    """Native batched containment offsets for try_copy_alignment
    (sina_contains over the shared flat mask store, in place of
    per-query string building).
    Returns {query_idx: int64 offsets array (one per family member,
    -1 = not contained)} or None when the caller must use the string
    path (no native lib / members not in one flat store)."""
    from . import native

    if native.get_lib() is None:
        return None
    idxs = [i for i, f in enumerate(families) if f]
    if not idxs:
        return None
    seqs = [it[1] for i in idxs for it in families[i]]
    fr = _flat_ranges(seqs)
    if fr is None:
        return None
    starts, counts, r0 = fr
    fam_sizes = np.array(
        [len(families[i]) for i in idxs], np.int64
    )
    qmasks = [
        (queries[i].masks & 0xF).astype(np.uint8) for i in idxs
    ]
    qoffsets = np.zeros(len(idxs) + 1, np.int64)
    np.cumsum([len(m) for m in qmasks], out=qoffsets[1:])
    offs = native.contains_batch(
        r0[1], starts, counts, fam_sizes,
        np.concatenate(qmasks) if qmasks else
        np.zeros(0, np.uint8),
        qoffsets,
    )
    if offs is None:
        return None
    out = {}
    cur = 0
    for i, sz in zip(idxs, fam_sizes):
        out[i] = offs[cur : cur + int(sz)]
        cur += int(sz)
    return out


def try_copy_alignment(
    query: Sequence,
    family: list[tuple[float, Sequence]],
    cfg: AlignerConfig,
    log: list[str],
    offsets: np.ndarray | None = None,
) -> tuple[Sequence | None, list[tuple[float, Sequence]]]:
    """Identity/superstring fast path (align.cpp:328-389): if a family
    member contains the query's bases verbatim, copy its alignment.
    With --realign those members are dropped instead.

    `offsets` (from _containment_batch) carries precomputed per-member
    containment offsets; the mask-level native check is equivalent to
    the normalized base-string test (4-bit IUPAC codes strip case and
    map U == T) and skips all string building."""
    if offsets is not None:
        cont_idx = [
            m for m in range(len(family)) if offsets[m] >= 0
        ]
        if not cont_idx:
            return None, family
        if cfg.realign:
            log.append(
                "sequences "
                + " ".join(
                    family[m][1].get_attr("acc", family[m][1].name)
                    for m in cont_idx
                )
                + " containing exact candidate removed from family;"
            )
            drop = set(cont_idx)
            return None, [
                it for m, it in enumerate(family) if m not in drop
            ]
        out = query.copy()
        if cfg.lowercase != LOWERCASE_ORIGINAL:
            out.upper_case_all()
        qlen = len(query.masks)
        exact_m = next(
            (m for m in cont_idx if len(family[m][1]) == qlen), None
        )
        if exact_m is not None:
            ref = family[exact_m][1]
            out.positions = ref.positions.copy()
            log.append(
                f"copied alignment from identical template sequence "
                f"{ref.get_attr('acc', ref.name)};"
            )
        else:
            m = cont_idx[0]
            ref = family[m][1]
            start = int(offsets[m])
            out.positions = ref.positions[
                start : start + qlen
            ].copy()
            log.append(
                f"copied alignment from (longer) template sequence "
                f"{ref.get_attr('acc', ref.name)};"
            )
        out.width = ref.width
        out.set_attr(FN_DATE, _now())
        out.set_attr(FN_QUAL, 100)
        if cfg.calc_idty:
            out.set_attr(FN_IDTY, 100.0)
        out.set_attr(FN_HEAD, 0)
        out.set_attr(FN_TAIL, 0)
        out.set_attr(FN_FILTER, "")
        return out, family

    bases = query.get_bases().upper().replace("U", "T")

    containing = []
    others = []
    for item in family:
        ref_bases = _norm_bases(item[1])
        if bases in ref_bases:
            containing.append((item, ref_bases))
        else:
            others.append(item)

    if not containing:
        return None, family

    if cfg.realign:
        log.append(
            "sequences "
            + " ".join(
                it[1].get_attr("acc", it[1].name)
                for it, _ in containing
            )
            + " containing exact candidate removed from family;"
        )
        return None, others

    out = query.copy()
    if cfg.lowercase != LOWERCASE_ORIGINAL:
        out.upper_case_all()
    exact = next(
        (
            (it, rb)
            for it, rb in containing
            if rb == bases
        ),
        None,
    )
    if exact is not None:
        ref = exact[0][1]
        # positions come from the template; bases/case stay the
        # query's own (align.cpp:355)
        out.positions = ref.positions.copy()
        log.append(
            f"copied alignment from identical template sequence "
            f"{ref.get_attr('acc', ref.name)};"
        )
    else:
        (item, ref_bases) = containing[0]
        ref = item[1]
        start = ref_bases.index(bases)
        out.positions = ref.positions[
            start : start + len(bases)
        ].copy()
        log.append(
            f"copied alignment from (longer) template sequence "
            f"{ref.get_attr('acc', ref.name)};"
        )
    out.width = ref.width
    out.set_attr(FN_DATE, _now())
    out.set_attr(FN_QUAL, 100)
    if cfg.calc_idty:
        out.set_attr(FN_IDTY, 100.0)
    out.set_attr(FN_HEAD, 0)
    out.set_attr(FN_TAIL, 0)
    out.set_attr(FN_FILTER, "")
    return out, family


def _bucket(n: int, step: int) -> int:
    return max(step, -(-n // step) * step)


def _flat_ranges(seqs: list[Sequence]):
    """(starts, counts, store_tuple) of the members' base ranges in
    their SHARED flat store, or None when any member lacks a current
    `_flat_ref` stamp or the stamps span different stores.  The one
    validation used by every flat-store fast path in this module
    (count-cols, windowed counts, containment)."""
    flats = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = flats[0] if flats else None
    if r0 is None or not all(
        f is not None and f[0] is r0[0] and f[4] is s.positions
        for f, s in zip(flats, seqs)
    ):
        return None
    n = len(seqs)
    starts = np.fromiter((f[2] for f in flats), np.int64, n)
    ends = np.fromiter((f[3] for f in flats), np.int64, n)
    return starts, ends - starts, r0


def _count_cols_batch(
    fam_refs: list[list[Sequence]],
) -> np.ndarray:
    """Occupied-column count per family (the profile engine's shape-
    bucketing input).  One native pass over the shared flat base
    store when every member carries a `_flat_ref` stamp; per-family
    numpy unique otherwise."""
    from . import native

    seqs = [r for refs in fam_refs for r in refs]
    fr = _flat_ranges(seqs)
    if fr is not None:
        starts, counts, r0 = fr
        fam_sizes = np.array(
            [len(refs) for refs in fam_refs], np.int64
        )
        out = native.count_cols(
            r0[0], starts, counts, fam_sizes,
            fam_refs[0][0].width,
        )
        if out is not None:
            return out
    return np.array(
        [
            len(
                np.unique(
                    np.concatenate([r.positions for r in refs])
                )
            )
            for refs in fam_refs
        ],
        np.int64,
    )


# Per-flat-store caches for _trim_windows: DB-global occupied
# columns (one bitmap pass over the flat base store, computed once
# per db) and per-top-reference anchor tables (persist across
# batches: dereplicated amplicon workloads repeat top refs).
_db_cols_cache = IdentityCache(1, "db_cols")  # one db at a time
_anchor_cache = IdentityCache(8192, "anchor")  # ~200MB worst case


def _db_occupied_cols(seq) -> np.ndarray | None:
    flat = getattr(seq, "_flat_ref", None)
    if flat is None:
        return None

    def build(flat_pos):
        # new db: drop anchors built against the previous one
        _anchor_cache.clear()
        occ = np.zeros(seq.width, dtype=bool)
        occ[flat_pos] = True
        return np.flatnonzero(occ).astype(np.int64)

    return _db_cols_cache.get(flat[0], build)


def _count_cols_range_batch(
    fam_refs: list[list[Sequence]],
    lo: np.ndarray,
    hi: np.ndarray,
) -> np.ndarray | None:
    """Exact occupied-column count per family inside raw-column
    window [lo, hi) (one native pass over the shared flat store, as
    _count_cols_batch); None when no shared store / native lib."""
    from . import native

    seqs = [r for refs in fam_refs for r in refs]
    fr = _flat_ranges(seqs)
    if fr is not None:
        starts, counts, r0 = fr
        fam_sizes = np.array(
            [len(refs) for refs in fam_refs], np.int64
        )
        return native.count_cols_range(
            r0[0], starts, counts, fam_sizes, lo, hi,
            fam_refs[0][0].width,
        )
    return None


def _trim_windows_native(cand, pend) -> list:
    """Batched native anchoring for the flat-store items of `cand`
    (sina_query_windows; semantics of ops/colspan.query_window, in
    place of a per-query python loop).  Appends [item, lo, hi, est, True] rows
    to `pend` and returns the items the caller must still anchor in
    python (no flat store / native lib unavailable)."""
    from . import native
    from .ops.colspan import _K, RefAnchorTable

    if native.get_lib() is None:
        return cand
    items = []
    rest = []
    store0 = None  # all native items must share ONE flat store: the
    # occupied-cols array below is per-store, so a batch mixing two
    # dbs would anchor the second db's queries against the wrong
    # columns — those route to the python fallback instead
    for it in cand:
        top = it[4][0]
        flat = getattr(top, "_flat_ref", None)
        if flat is not None and _db_occupied_cols(top) is not None:
            if store0 is None:
                store0 = flat[0]
            if flat[0] is store0:
                items.append(it)
                continue
        rest.append(it)
    if not items:
        return rest
    cols = _db_occupied_cols(items[0][4][0])
    tops: dict[int, int] = {}
    tables: list[tuple] = []  # (vals, pos, n_bases, positions)
    qtable = np.empty(len(items), np.int64)
    for i, it in enumerate(items):
        top = it[4][0]
        ti = tops.get(id(top))
        if ti is None:
            table = _anchor_cache.get(
                top, lambda t: RefAnchorTable(t.masks)
            )
            ti = tops[id(top)] = len(tables)
            tables.append(
                (table.vals, table.pos, table.n_bases,
                 top.positions)
            )
        qtable[i] = ti
    tbl_offsets = np.zeros(len(tables) + 1, np.int64)
    np.cumsum([len(t[0]) for t in tables], out=tbl_offsets[1:])
    rpos_offsets = np.zeros(len(tables) + 1, np.int64)
    np.cumsum([len(t[3]) for t in tables], out=rpos_offsets[1:])
    qoffsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum(
        [len(it[1].masks) for it in items], out=qoffsets[1:]
    )
    wins = native.query_windows(
        np.concatenate([it[1].masks for it in items]),
        qoffsets,
        np.concatenate([t[0] for t in tables]),
        np.concatenate([t[1] for t in tables]),
        tbl_offsets,
        np.array([t[2] for t in tables], np.int64),
        np.concatenate([t[3] for t in tables]),
        rpos_offsets,
        qtable, cols, _K,
    )
    if wins is None:
        return cand
    for it, row in zip(items, wins):
        if row[0] >= 0:
            pend.append(
                [it, int(row[0]), int(row[1]), int(row[2]), True]
            )
    return rest


def _trim_windows(todo, min_cols: int = 0) -> None:
    """Shrink each profile-engine item's DP lattice to the query's
    anchored column window (ops/colspan.py).  Engages only when the
    query is short relative to the family span (amplicon workloads)
    AND anchoring is confident; otherwise the item keeps its full
    lattice.  On success item[6] becomes the window-size bound (the
    shape-bucketing input) and item[8] the raw column window start
    (the dispatcher converts it to family occupied-column ranks once
    the profile build has handed it the family's columns); item[9]
    keeps the family's full column count."""
    from .ops.colspan import SNAP_GRID, RefAnchorTable, query_window

    fam_cols_cache: dict[tuple, np.ndarray] = {}
    # candidate items past the cheap gates: narrow lattices aren't
    # worth the host anchoring cost (see AlignerConfig.
    # col_trim_min_cols); full-length queries can't save >25%
    cand = [
        it
        for it in todo
        if it[6] >= min_cols and 2 * len(it[1].masks) < it[6]
    ]
    if not cand:
        return
    # [item, lo_col, hi_col, est, db_ranked]
    pend: list[list] = []
    rest = _trim_windows_native(cand, pend)
    for it in rest:
        q = it[1]
        refs = it[4]
        top = refs[0]
        db_cols = _db_occupied_cols(top)
        db_ranked = db_cols is not None
        if not db_ranked:
            # no shared flat store (ad-hoc families, tests): fall
            # back to this family's own occupied columns
            fk = tuple(id(r) for r in refs)
            db_cols = fam_cols_cache.get(fk)
            if db_cols is None:
                occ = np.zeros(top.width, dtype=bool)
                for r in refs:
                    occ[r.positions] = True
                db_cols = np.flatnonzero(occ).astype(np.int64)
                fam_cols_cache[fk] = db_cols
        table = _anchor_cache.get(
            top, lambda t: RefAnchorTable(t.masks)
        )
        win = query_window(q.masks, table, top.positions, db_cols)
        if win is None:
            continue
        pend.append([it, win[0], win[1], win[2], db_ranked])
    if not pend:
        return
    # whole-db rank estimates over-count the window by the db/family
    # column-density ratio (a ~790-col amplicon window was bucketing
    # at 1024 instead of 512); one batched native pass replaces them
    # with the family's exact in-window occupied count.  The family-
    # fallback estimates above are already exact.
    ref_rows = [p for p in pend if p[4]]
    if ref_rows:
        exact = _count_cols_range_batch(
            [p[0][4] for p in ref_rows],
            np.array([p[1] for p in ref_rows], np.int64),
            np.array([p[2] for p in ref_rows], np.int64),
        )
        if exact is not None:
            for p, ex in zip(ref_rows, exact):
                p[3] = int(ex)
    for it, lo_col, hi_col, est, _ in pend:
        # the dispatcher snaps the start rank down to the shared
        # grid; cover that extension in the size estimate
        est += SNAP_GRID
        if 4 * est >= 3 * it[6]:
            continue  # <25% saving: not worth a new shape class
        it[6] = est
        it[8] = (lo_col, hi_col)



def align_dispatch(
    queries: list[Sequence],
    families: list[list[tuple[float, Sequence]]],
    cfg: AlignerConfig | None = None,
    col_weights_list: list[np.ndarray | None] | None = None,
    astats_names: list[str] | None = None,
    node_bucket: int = 512,
    query_bucket: int = 256,
    device: torch.device | str = "cuda",
):
    """Dispatch a batch alignment WITHOUT fetching: runs the copy
    path, builds profiles/graphs and launches the device DP per shape
    bucket, then returns an in-flight handle for align_finalize
    (sina_tpu/align.py:584-806)."""
    cfg = cfg or AlignerConfig()
    engine = cfg.resolved_engine()
    device = torch.device(device)
    B = len(queries)
    col_weights_list = col_weights_list or [None] * B
    astats_names = astats_names or [""] * B
    results: list[Sequence | None] = [None] * B

    todo = []  # (idx, q_upper, template, cw, refs, log)
    graph_cache: dict[tuple, LinearGraph] = {}
    with get_timer("Aligner").section("copy path"):
        with get_timer("Aligner").section("copy: containment"):
            cont = _containment_batch(queries, families)
        if cont is None and any(families):
            # the native batch declined (no lib / mixed or missing flat
            # stores) — the per-query string path below costs far more
            # host time, so make that visible in the counters
            timing.count("align.copy_string_fallback")
        for idx, (query, family) in enumerate(zip(queries, families)):
            if not family:
                continue
            log: list[str] = []
            copied, family = try_copy_alignment(
                query, family, cfg, log,
                offsets=cont.get(idx) if cont is not None else None,
            )
            # the reference's tray shares the family vector, so later
            # stages see the aligner's filtering (align.cpp:337-345);
            # mirror that by updating the caller's list in place
            families[idx] = family
            if copied is not None:
                copied.set_attr("align_log_slv", " ".join(log))
                results[idx] = copied
                continue
            if not family:
                continue
            refs = [it[1] for it in family]
            top_score = family[0][0]  # dist for the subst-matrix scheme
            if engine == "graph":
                # identical families (shared Sequence objects from the
                # famfinder) build one graph, like the profile dedup;
                # graphs for the whole batch build in one parallel native
                # pass after this loop (build_graphs_batch)
                gkey = tuple(id(r) for r in refs)
                template = graph_cache.get(gkey)
                if col_weights_list[idx] is not None:
                    cw = np.ones(refs[0].width + 2, dtype=np.float32)
                    w = col_weights_list[idx]
                    cw[: len(w)] = w
                else:
                    cw = _ones_cw(refs[0].width)
                n_shape = template.n_nodes if template is not None else -1
            else:
                # profile construction happens batched per bucket; only
                # the occupied-column count is needed for bucketing and
                # is computed in one batched pass after this loop
                n_shape = -1
                template = None
                cw = _ones_cw(refs[0].width)
            q = query.copy()
            if cfg.lowercase != LOWERCASE_ORIGINAL:
                q.upper_case_all()
            todo.append(
                [idx, q, template, cw, refs, log, n_shape, top_score]
            )

    if todo and engine == "graph":
        from .ops.graph import build_graphs_batch

        pending = [it for it in todo if it[2] is None]
        if pending:
            ukeys: dict[tuple, int] = {}
            ufams: list[list[Sequence]] = []
            for it in pending:
                kkey = tuple(id(r) for r in it[4])
                if kkey not in ukeys:
                    ukeys[kkey] = len(ufams)
                    ufams.append(it[4])
            with get_timer("Aligner").section("build graph"):
                built = build_graphs_batch(ufams, cfg.fs_weight)
            for kkey, ui in ukeys.items():
                graph_cache[kkey] = built[ui]
            for it in pending:
                it[2] = graph_cache[tuple(id(r) for r in it[4])]
                it[6] = it[2].n_nodes
        if cfg.debug_graph:
            from .ops.graph import graph_to_dot

            for it in todo:
                # reference naming: mseq_<name>.dot (align.cpp:511-513)
                name = queries[it[0]].name or it[0]
                fname = f"mseq_{name}.dot"
                with open(fname, "w") as fh:
                    fh.write(graph_to_dot(it[2]))
                logger.info("wrote %s", fname)

    if todo and cfg.debug_lattice:
        from .debug_dump import dump_lattice

        lo, _, hi = cfg.debug_lattice.partition(":")
        col_from = int(lo) if lo else 0
        col_to = int(hi) if hi else None
        for it in todo:
            name = queries[it[0]].name or it[0]
            fname = f"lattice_{name}.dot"
            dump_lattice(
                it[1], [(0.0, r) for r in it[4]], fname,
                col_from, col_to, cfg.dp_params(), cfg.fs_weight,
                device=device,
            )
            logger.info("wrote %s", fname)

    if todo and engine != "graph":
        with get_timer("Aligner").section("count cols"):
            counts = _count_cols_batch([it[4] for it in todo])
        for it, c in zip(todo, counts):
            it[6] = int(c)
            # [8] = window start (occupied-column space), [9] = the
            # family's full occupied-column count (profile build size)
            it.extend((0, int(c)))
        if cfg.col_trim:
            with get_timer("Aligner").section("col trim"):
                _trim_windows(todo, cfg.col_trim_min_cols)

    # group into shape buckets.  The graph engine snaps both axes
    # coarsely (sina_tpu/align.py:727-749): nodes to powers of two (min
    # 2048), query length to 512-steps up to 2048 and powers of two
    # beyond.  The profile engine: 256-step classes below 1024 columns
    # (col-trimmed amplicon windows land at ~500-800), the coarse
    # node_bucket grid above
    def _pow2(v: int, lo: int) -> int:
        return max(lo, 1 << max(int(v) - 1, 1).bit_length())

    buckets: dict[tuple[int, int], list] = {}
    for item in todo:
        n_shape = item[6]
        q = item[1]
        if engine == "graph":
            m = len(q.masks)
            key = (
                _pow2(n_shape, 2048),
                _bucket(m, 512) if m <= 2048 else _pow2(m, 2048),
            )
        else:
            key = (
                _bucket(n_shape, 256)
                if n_shape <= 1024 - 256
                else _bucket(n_shape, node_bucket),
                _bucket(len(q.masks), query_bucket),
            )
        buckets.setdefault(key, []).append(item)

    if engine != "graph" and len(buckets) > 1:
        # merge near-size profile buckets into one padded launch
        # (sina_tpu/align.py:763-787): rows carry their real sizes
        # (cr), so merging only changes padding, not results.  Merge
        # ONLY into an already-existing key; distant classes stay
        # separate — there the padding would dominate.
        keys = list(buckets)
        cmax = max(k[0] for k in keys)
        mmax = max(k[1] for k in keys)
        if (cmax, mmax) in buckets and all(
            4 * k[0] >= 3 * cmax and 4 * k[1] >= 3 * mmax
            for k in keys
        ):
            merged: list = []
            for k in keys:
                merged.extend(buckets[k])
            buckets = {(cmax, mmax): merged}

    params = cfg.dp_params()
    thunks = []
    for (npad, mpad), items in buckets.items():
        dispatch = (
            _dispatch_graph_bucket if engine == "graph"
            else _dispatch_profile_bucket
        )
        thunks.append(
            dispatch(
                items, npad, mpad, params, cfg, queries,
                astats_names, results, device,
            )
        )
    return results, thunks


def align_finalize(state) -> list[Sequence | None]:
    """Fetch + post-process an align_dispatch handle."""
    results, thunks = state
    for t in thunks:
        t()
    return results


def align_batch(
    queries: list[Sequence],
    families: list[list[tuple[float, Sequence]]],
    cfg: AlignerConfig | None = None,
    col_weights_list: list[np.ndarray | None] | None = None,
    astats_names: list[str] | None = None,
    node_bucket: int = 512,
    query_bucket: int = 256,
    device: torch.device | str = "cuda",
) -> list[Sequence | None]:
    """Align a batch of queries, each against its own family
    (synchronous dispatch+finalize; sina_tpu/align.py:817-833)."""
    return align_finalize(
        align_dispatch(
            queries, families, cfg, col_weights_list, astats_names,
            node_bucket, query_bucket, device=device,
        )
    )


def align_sequence(
    query: Sequence,
    family: list[tuple[float, Sequence]],
    cfg: AlignerConfig | None = None,
    col_weights: np.ndarray | None = None,
    astats_name: str = "",
    device: torch.device | str = "cuda",
) -> Sequence | None:
    """Align one query against its reference family (single-sequence
    convenience wrapper over align_dispatch and align_finalize;
    sina_tpu/align.py:1361-1375)."""
    cfg = cfg or AlignerConfig()
    return align_finalize(align_dispatch(
        [query], [list(family)], cfg, [col_weights], [astats_name], device=device,
    ))[0]


def _max_pred_distance(graph: LinearGraph) -> int:
    """The largest topological distance j - p from a node j to one of
    its predecessors p (0 for a graph without edges)."""
    v = graph.preds >= 0
    if not v.any():
        return 0
    return int((np.arange(graph.n_nodes, dtype=np.int32)[:, None] - graph.preds)[v].max())


def align_sequence_host_traceback(
    query: Sequence,
    family: list[tuple[float, Sequence]],
    cfg: AlignerConfig | None = None,
    device: torch.device | str = "cuda",
) -> Sequence | None:
    """Graph-mode alignment of one query by the dense DP on `device`
    (ops/align_kernel.graph_dp_dense) and the host walk
    (ops/align_kernel.traceback): the oracle of the device walks
    (sina_tpu/align.py:1377-1427)."""
    cfg = cfg or AlignerConfig()
    log: list[str] = []

    copied, family = try_copy_alignment(query, family, cfg, log)
    if copied is not None:
        copied.set_attr("align_log_slv", " ".join(log))
        return copied
    if not family:
        return None

    refs = [it[1] for it in family]
    graph = build_graph(refs, cfg.fs_weight)
    cw = np.ones(graph.width + 2, dtype=np.float32)
    q = query.copy()
    if cfg.lowercase != LOWERCASE_ORIGINAL:
        q.upper_case_all()

    n, m = graph.n_nodes, len(q.masks)

    def up(a, dtype):
        """One query's array as a batch of one on `device`."""
        return torch.from_numpy(np.asarray(a, dtype=dtype)[None].copy()).to(device)

    bp, bj, bi, raw = ak.graph_dp_dense(
        up(graph.pos, np.int32), up(graph.mask, np.uint8),
        up(graph.weight, np.float32), up(graph.preds, np.int32),
        up(graph.is_start, bool), up(graph.is_end, bool),
        up(q.masks, np.uint8), up(m, np.int32), up(n, np.int32),
        up(cw, np.float32), cfg.dp_params(), maxd=_max_pred_distance(graph),
    )
    bj, bi, raw = int(bj[0]), int(bi[0]), float(raw[0])
    pairs, head = ak.traceback(
        bp[0].cpu().numpy(), bj, bi, graph.pos, graph.preds, graph.is_start,
    )
    return finish_alignment(
        query, q, graph.pos, graph.weight, graph.width,
        pairs, head, bj, bi, raw,
        cfg, cw, refs, astats_name="", log=log,
    )


class _StackArena:
    """Reusable host buffers for the graph batch planes
    (sina_tpu/align.py:900-932): large fresh np.zeros/np.full planes
    per dispatch made the host "stack" section swing with allocator
    behaviour (mmap, free, refault).  Banks are acquired per dispatch
    and released by that dispatch's finalize closure, so a buffer is
    never refilled while a copy of it may still be pending.  For a
    CUDA device the planes are pinned, lent by ops/transfer's pool to
    the bank for as long as it keeps them."""

    def __init__(self):
        self._free: list[dict] = []

    def acquire(self) -> dict:
        return self._free.pop() if self._free else dict()

    def release(self, bank: dict) -> None:
        self._free.append(bank)

    @staticmethod
    def take(bank: dict, key: str, shape, dtype, device: torch.device) -> torch.Tensor:
        """The bank's `key` plane as a host tensor of `shape` and numpy
        `dtype` (contents undefined), for data bound for `device`
        (pinned on a CUDA device): the bank's own buffer where it is of
        that kind and large enough, else a new one (the old one goes
        back to the pool)."""
        shape = tuple(shape)
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        held = bank.get(key)
        if held is None or held[1] != device or held[0].numel() < nbytes:
            if held is not None:
                transfer.release(*held)
            held = bank[key] = (transfer.host_buffer(nbytes, device), device)
        return held[0][:nbytes].view(transfer.torch_dtype(dtype)).view(shape)


_stack_arena = _StackArena()

_ones_cw_cache: dict[int, np.ndarray] = {}


def _ones_cw(width: int) -> np.ndarray:
    """Shared all-ones column-weight array (read-only by contract).

    One array per width instead of np.ones(width + 2) per query: at
    SILVA width (50k) that would be 25MB of freshly-faulted pages per
    128-query batch."""
    a = _ones_cw_cache.get(width)
    if a is None:
        a = np.ones(width + 2, dtype=np.float32)
        a.flags.writeable = False  # enforce the read-only contract
        _ones_cw_cache.clear()  # one width per db in practice
        _ones_cw_cache[width] = a
    return a


def _dispatch_graph_bucket(
    items, npad, mpad, params, cfg, queries, astats_names, results,
    device,
):
    """Stack one bucket's graphs and launch the graph DP and its
    traceback (sina_tpu/align.py:956-1131); returns the finalize
    thunk.  A bucket whose largest predecessor distance fits the graph
    kernel's 5-bit fields (< 32: true of the families testing's
    generators make, unless with_long_insertion adds to them) launches the graph DP and its traceback at once,
    without chunking; a larger one (any family member with an indel of
    about 32 columns against relatives with bases there makes one)
    launches the dense DP and its traceback, chosen by shape as the
    reference chooses its core.  Device work is queued without
    synchronising; the thunk fetches it."""
    from .ops.graph_kernel import (
        check_walks, graph_dp, graph_traceback, pack_graph_host,
        pick_k_ring,
    )

    tg = get_timer("GraphDP")
    # the bucket shapes formed, with their query counts
    timing.count(f"graph_dp.bucket {npad}x{mpad}", len(items))
    subst = None
    if cfg.use_subst_matrix:
        # experimental matrix scheme: per-family log-odds matrix from
        # family base frequencies at the family's top identity
        # (align.cpp:417-427; the reference's own matrix generator is
        # disabled upstream — see stats.subst_matrix)
        from .stats import family_base_freqs, subst_matrix

        subst = np.stack(
            [
                subst_matrix(
                    family_base_freqs(it[4]), float(it[7])
                )
                for it in items
            ]
        ).astype(np.float32)
        for it in items:
            it[5].append(f"using dist: {float(it[7]):.6g};")
    with tg.section("stack"):
        # batch node planes filled straight from each COMPACT graph
        # (padding semantics of ops.graph.pad_graph inlined: isolated
        # non-start non-end nodes at the final column), from the
        # rotating arena; P snaps to a multiple of 4 so family-to-
        # family pred-width jitter doesn't defeat buffer reuse
        B = len(items)
        width0 = items[0][2].width
        P = max(it[2].preds.shape[1] for it in items)
        P = -(-P // 4) * 4
        wmax = max(len(it[3]) for it in items)
        # the graph kernel when every predecessor is nearby in topological
        # order: 0 < maxd < 32, the reference's window test
        # (sina_tpu/align.py:1051); true of the repo's generated families,
        # not of one with a member whose indel spans about 32 columns
        maxd = max(_max_pred_distance(it[2]) for it in items)
        k_ring = pick_k_ring(maxd) if maxd > 0 else 0
        bank = _stack_arena.acquire()

        def take(key, shape, dtype, fill, upload=True):
            # pinned where the plane crosses to the device; the graph
            # kernel's route packs preds, start and end on the host
            t = _StackArena.take(bank, key, shape, dtype,
                                 device if upload else torch.device("cpu"))
            t.numpy().fill(fill)
            return t

        # every query's column weights the shared ones (no positional
        # variability filter): the plane is made on the device, no copy
        ones = _ones_cw_cache.get(width0)
        cw_t = (None if all(it[3] is ones for it in items)
                else take("cw", (B, wmax), np.float32, 1))
        qm_t = take("qm", (B, mpad), np.uint8, 0)
        ql_t = take("ql", (B,), np.int32, 0)
        nr_t = take("nr", (B,), np.int32, 0)
        pos_t = take("pos", (B, npad), np.int32, width0 - 1)
        mask_t = take("mask", (B, npad), np.uint8, 0)
        weight_t = take("weight", (B, npad), np.float32, 0)
        preds_t = take("preds", (B, npad, P), np.int32, -1, upload=not k_ring)
        start_t = take("start", (B, npad), bool, False, upload=not k_ring)
        end_t = take("end", (B, npad), bool, False, upload=not k_ring)
        maxi_t = (take("maxi", (B, npad), np.int32, 0)
                  if cfg.insertion == INSERTION_FORBID else None)
        qm, ql, nr = (t.numpy() for t in (qm_t, ql_t, nr_t))
        cw_pad = None if cw_t is None else cw_t.numpy()
        pos_s, mask_s, weight_s, preds_s, start_s, end_s = (
            t.numpy() for t in (pos_t, mask_t, weight_t, preds_t, start_t, end_t))
        maxi_s = None if maxi_t is None else maxi_t.numpy()
        for b, it in enumerate(items):
            _, q, g, cw = it[:4]
            qm[b, : len(q.masks)] = q.masks
            ql[b] = len(q.masks)
            nr[b] = g.n_nodes
            if cw_pad is not None:
                cw_pad[b, : len(cw)] = cw
            n = g.n_nodes
            pos_s[b, :n] = g.pos
            mask_s[b, :n] = g.mask
            weight_s[b, :n] = g.weight
            preds_s[b, :n, : g.preds.shape[1]] = g.preds
            start_s[b, :n] = g.is_start
            end_s[b, :n] = g.is_end
            if maxi_s is not None:
                maxi_s[b, :n] = g.max_insert

    def up(a):
        """A bank plane (pinned on a CUDA device) or a numpy array on
        the device, without blocking the host."""
        return None if a is None else transfer.upload(a, device)

    if k_ring:
        with tg.section("pack"):
            _, predbits, flags = pack_graph_host(
                mask_s, preds_s, start_s, end_s, nr
            )
    else:
        # a predecessor 32 or more topological positions back (or no
        # edge at all): the kernel's distance fields cannot hold it, so
        # the bucket takes the reference's dense core
        # (sina_tpu/align.py:1051,1084-1105)
        logger.info(
            "graph bucket (%d x %d, %d queries): largest predecessor "
            "distance %d is not in 1..31, taking the dense route",
            npad, mpad, B, maxd,
        )
        kernels.launches["graph_dense_route"] += 1
    with tg.section("launch"):
        cw_d = (torch.ones((B, wmax), dtype=torch.float32, device=device)
                if cw_t is None else up(cw_t))
        if k_ring:
            flags_d = up(flags)
            bp, bj, bi, raw = graph_dp(
                up(pos_t), up(mask_t), up(weight_t), up(predbits),
                flags_d, up(qm_t), up(ql_t), cw_d, up(maxi_t), up(subst),
                params=params, k_ring=k_ring,
            )
            emit, done = graph_traceback(bp, bj, bi, flags_d)
        else:
            preds_d, start_d = up(preds_t), up(start_t)
            bp, bj, bi, raw = ak.graph_dp_dense(
                up(pos_t), up(mask_t), up(weight_t), preds_d, start_d,
                up(end_t), up(qm_t), up(ql_t), up(nr_t), cw_d, params,
                max_insert=up(maxi_t), subst=up(subst), maxd=maxd,
            )
            emit, done = ak.graph_traceback_dense(bp, bj, bi, preds_d, start_d)
        # one (B, M+4) int32 result = one device-to-host copy, started
        # now on the copy stream (JAX: copy_to_host_async,
        # sina_tpu/align.py:1106-1110)
        out = torch.cat(
            [emit, bj.to(torch.int32)[:, None], bi.to(torch.int32)[:, None],
             raw.view(torch.int32)[:, None], done[:, None]],
            dim=1,
        )
        fetch = transfer.fetch_async(out)
        del bp, out

    def finalize():
        with tg.section("fetch"):
            packed = fetch.result()
        # the copy's done event follows, on the copy stream, an event
        # recorded on the compute stream after this bucket's uploads:
        # no host-to-device copy is still reading the bank's planes,
        # so the next bucket may refill them
        _stack_arena.release(bank)
        emit_h = packed[:, :-4]
        bj_h, bi_h = packed[:, -4], packed[:, -3]
        raw_h = packed[:, -2].copy().view(np.float32)
        check_walks(packed[:, -1])
        with tg.section("finish"):
            for b, it in enumerate(items):
                idx, q, graph, cw, refs, log = it[:6]
                eidx = np.nonzero(emit_h[b] >= 0)[0]
                head = int(eidx[0]) if len(eidx) else 0
                pairs = (emit_h[b][eidx], eidx)
                results[idx] = finish_alignment(
                    queries[idx], q, graph.pos, graph.weight,
                    graph.width, pairs, head, int(bj_h[b]), int(bi_h[b]),
                    float(raw_h[b]), cfg, cw, refs, astats_names[idx],
                    list(log),
                )

    return finalize


def _dispatch_profile_bucket(
    items, cpad, mpad, params, cfg, queries, astats_names, results,
    device,
):
    """Build one bucket's profiles and launch its DP
    (sina_tpu/align.py:1134-1358; with --insertion forbid each query
    row also carries its insertion budgets); returns the finalize
    thunk."""
    from .ops.profile import (
        build_profiles_packed_batch,
        profile_dp_dispatch,
        profile_dp_fetch,
    )

    t = get_timer("Aligner")
    B = len(items)
    width = items[0][4][0].width
    aspace = cfg.insertion == INSERTION_FORBID

    # dedup identical families (amplicon batches repeat them): the
    # profile is built once per UNIQUE family, and each UNIQUE
    # (family, window-start) pair becomes one device row — a
    # col-trimmed item (item[8] = (lo_col, hi_col) raw columns, see
    # _trim_windows) slices its window out of the full profile; the
    # device gathers each query's row (famfinder hands out the db's
    # shared Sequence objects, so identity keys suffice)
    fkeys: dict[tuple, int] = {}
    ffams: list[list] = []
    item_fi = np.zeros(B, dtype=np.int32)
    for b, it in enumerate(items):
        fk = tuple(id(r) for r in it[4])
        fi = fkeys.get(fk)
        if fi is None:
            fi = len(ffams)
            fkeys[fk] = fi
            ffams.append(it[4])
        item_fi[b] = fi
    any_win = any(
        len(it) > 8 and it[8] != 0 for it in items
    )
    c_full_max = max(
        it[9] if len(it) > 9 else it[6] for it in items
    )
    fam_full_c = {}
    for b, it in enumerate(items):
        fam_full_c[int(item_fi[b])] = (
            it[9] if len(it) > 9 else it[6]
        )
    # window-restricted builds: when every item of a family carries a
    # column window, its profile (and cols array) only needs the
    # union window — an amplicon batch otherwise builds mostly
    # out-of-window bases.  aspace (insertion=forbid) keeps full builds:
    # its boundary budget needs the first occupied column AFTER the
    # window.  Everything downstream (ws ranks, slices, finalize)
    # already works in the returned cols space.
    fam_windows = None
    with t.section("window calc"):
        if any_win and not aspace:
            from .ops.profile import can_window_batch

            if can_window_batch(ffams):
                nf = len(ffams)
                wlo: list[int | None] = [None] * nf
                whi: list[int | None] = [None] * nf
                full_fam = [False] * nf
                for b, it in enumerate(items):
                    fi = int(item_fi[b])
                    win = it[8] if len(it) > 8 else 0
                    if win == 0:
                        full_fam[fi] = True
                    else:
                        wlo[fi] = (
                            win[0] if wlo[fi] is None
                            else min(wlo[fi], win[0])
                        )
                        whi[fi] = (
                            win[1] if whi[fi] is None
                            else max(whi[fi], win[1])
                        )
                fam_windows = [
                    None
                    if full_fam[fi] or wlo[fi] is None
                    else (wlo[fi], whi[fi])
                    for fi in range(nf)
                ]
                if not any(w is not None for w in fam_windows):
                    fam_windows = None
        if fam_windows is not None:
            widx = [
                fi for fi, w in enumerate(fam_windows) if w is not None
            ]
            wcounts = _count_cols_range_batch(
                [ffams[fi] for fi in widx],
                np.array([fam_windows[fi][0] for fi in widx], np.int64),
                np.array([fam_windows[fi][1] for fi in widx], np.int64),
            )
            if wcounts is None:
                fam_windows = None
            else:
                wc = {fi: int(c) for fi, c in zip(widx, wcounts)}
                c_need = max(
                    wc.get(fi, c)
                    for fi, c in fam_full_c.items()
                )
    # sliced-row path needed when any row is a window, or when a
    # length-trimmed window starting at column 0 left the bucket cpad
    # smaller than the family's full span
    if fam_windows is not None:
        cpad_build = _bucket(max(c_need, 1), 512)
        trimmed = True
    elif not any_win and c_full_max <= cpad:
        cpad_build = cpad
        trimmed = False
    else:
        cpad_build = _bucket(c_full_max, 512)
        trimmed = True
    # profiles are built straight into the quantised device wire
    # format (6 B/col, ops/profile._pack_fgq layout): the f32
    # freqs/gapcost intermediates never materialise on the host
    with t.section("build profile"):
        fgq_f, cols_list = build_profiles_packed_batch(
            ffams, cpad_build, params, windows=fam_windows
        )
    with t.section("pack rows"):
        # raw column windows -> family occupied-column start ranks
        # (snapped to the shared SNAP_GRID so repeated queries dedup —
        # the grid size is included in _trim_windows' size estimate),
        # then unique (family, start) pairs become the device rows
        from .ops.colspan import SNAP_GRID

        rkeys: dict[tuple, int] = {}
        row_fam: list[int] = []
        row_ws: list[int] = []
        fam_idx = np.zeros(B, dtype=np.int32)
        for b, it in enumerate(items):
            fi = int(item_fi[b])
            win = it[8] if len(it) > 8 else 0
            if win != 0:
                ws = (
                    int(np.searchsorted(cols_list[fi], win[0]))
                    // SNAP_GRID
                ) * SNAP_GRID
            else:
                ws = 0
            rk = (fi, ws)
            u = rkeys.get(rk)
            if u is None:
                u = len(row_fam)
                rkeys[rk] = u
                row_fam.append(fi)
                row_ws.append(ws)
            fam_idx[b] = u
        U = len(row_fam)
        dedup = U < B
        # the dedup ratio U/B of the profile rows
        timing.count("profile.rows", B)
        timing.count("profile.distinct", U)
        if trimmed or len(ffams) < U:
            # materialise the device rows: window slices of the full
            # packed profiles (zero-padded past each family's end)
            fgq = np.zeros((U, cpad, 6), dtype=np.uint8)
            for u in range(U):
                fi, ws = row_fam[u], row_ws[u]
                n = min(cpad, cpad_build - ws)
                fgq[u, :n] = fgq_f[fi, ws : ws + n]
        else:
            fgq = fgq_f[:, :cpad]
        if dedup:
            # bucket U to the next power of two for stable compile shapes
            upad = min(B, 1 << max(U - 1, 0).bit_length())
            if upad > U:
                fgq = np.pad(fgq, ((0, upad - U), (0, 0), (0, 0)))
        qmask = np.zeros((B, mpad), dtype=np.uint8)
        ql = np.zeros(B, dtype=np.int32)
        cr = np.zeros(B, dtype=np.int32)
        budget = np.zeros((B, cpad), dtype=np.int32) if aspace else None
        for b, it in enumerate(items):
            q = it[1]
            u = int(fam_idx[b])
            fi, ws = row_fam[u], row_ws[u]
            cols_f = cols_list[fi]
            Cf = len(cols_f)
            end = min(ws + cpad, Cf)
            wl = end - ws
            qmask[b, : len(q.masks)] = q.masks
            ql[b] = len(q.masks)
            cr[b] = wl
            if aspace and wl > 0:
                # free columns between occupied columns (mesh.h:480-484);
                # a trimmed window's last slot gets the gap to the next
                # occupied column outside the window
                budget[b, : wl - 1] = (
                    np.diff(cols_f[ws:end].astype(np.int64)) - 1
                )
                budget[b, wl - 1] = (
                    width - int(cols_f[-1]) - 1
                    if end == Cf
                    else int(cols_f[end]) - int(cols_f[end - 1]) - 1
                )
    with t.section("profile dp dispatch"):
        handle = profile_dp_dispatch(
            fgq, qmask, ql, cr, params, device,
            fam_idx=fam_idx if dedup else None, budget=budget,
        )

    def finalize():
        with t.section("profile dp fetch"):
            emit, bc, bi, raw = profile_dp_fetch(handle)
        with t.section("finish"):
            for b, it in enumerate(items):
                idx, q, _, cw, refs, log = it[:6]
                eidx = np.nonzero(emit[b] >= 0)[0]
                head = int(eidx[0]) if len(eidx) else 0
                pairs = (emit[b][eidx], eidx)
                u = int(fam_idx[b])
                fi, ws = row_fam[u], row_ws[u]
                cols = cols_list[fi][ws : ws + int(cr[b])]
                ones = np.ones(len(cols), dtype=np.float32)
                results[idx] = finish_alignment(
                    queries[idx], q, cols, ones, width,
                    pairs, head, int(bc[b]), int(bi[b]),
                    float(raw[b]),
                    cfg, cw, refs, astats_names[idx], list(log),
                )

    return finalize


def _write_path_svg(
    fname: str, cols: np.ndarray, idx: np.ndarray, width: int,
    m: int,
) -> None:
    """SVG of the DP alignment path (column vs query base) — the
    redesigned equivalent of the reference's mesh_to_svg lattice dump
    (mesh_debug.h:103-193; the dense lattice never reaches the host
    here, so the path itself is what there is to draw)."""
    W, H, PAD = 800, 500, 40
    if len(cols) == 0 or width <= 1 or m <= 1:
        return
    xs = PAD + (W - 2 * PAD) * cols.astype(float) / max(width - 1, 1)
    ys = PAD + (H - 2 * PAD) * idx.astype(float) / max(m - 1, 1)
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
        f'height="{H}">\n'
        f'<rect width="{W}" height="{H}" fill="white"/>\n'
        f'<line x1="{PAD}" y1="{H-PAD}" x2="{W-PAD}" y2="{H-PAD}" '
        'stroke="black"/>\n'
        f'<line x1="{PAD}" y1="{PAD}" x2="{PAD}" y2="{H-PAD}" '
        'stroke="black"/>\n'
        f'<text x="{W//2}" y="{H-8}" font-size="12">alignment '
        f'column (0..{width - 1})</text>\n'
        f'<text x="4" y="{H//2}" font-size="12" '
        f'transform="rotate(-90 12,{H//2})">query base '
        f'(0..{m - 1})</text>\n'
        f'<polyline points="{pts}" fill="none" stroke="crimson" '
        'stroke-width="1.5"/>\n'
        "</svg>\n"
    )
    with open(fname, "w") as fh:
        fh.write(svg)
    logger.info("wrote %s", fname)


def finish_alignment(
    query: Sequence,
    q_upper: Sequence,
    pos_arr: np.ndarray,
    w_arr: np.ndarray,
    width: int,
    pairs: list[tuple[int, int]],
    head: int,
    best_j: int,
    best_i: int,
    raw: float,
    cfg: AlignerConfig,
    col_weights: np.ndarray,
    refs: list[Sequence],
    astats_name: str,
    log: list[str],
) -> Sequence | None:
    """Host post-processing: overhang, NAST shift, attrs
    (mesh.h:534-739 + align.cpp:475-521 semantics).  `pairs` is the
    traceback emission [(node, slave_i)] left-to-right; `head` the
    first consumed slave index; `pos_arr`/`w_arr` map node ids to
    alignment columns and match weights (graph nodes or profile
    columns)."""
    m = len(q_upper.masks)

    lowercase_unaligned = cfg.lowercase == LOWERCASE_UNALIGNED
    qmasks = q_upper.masks

    cutoff_head = head
    cutoff_tail = m - 1 - best_i

    if isinstance(pairs, tuple):
        body_nodes, body_idx = pairs
        body_nodes = body_nodes.astype(np.int64)
        body_idx = body_idx.astype(np.int64)
    else:
        body_nodes = np.asarray([n for n, _ in pairs], dtype=np.int64)
        body_idx = np.asarray([i for _, i in pairs], dtype=np.int64)
    seg_pos = []
    seg_mask = []

    # left overhang (mesh.h:690-721)
    if head > 0 and cfg.overhang != OVERHANG_REMOVE:
        pfirst = int(pos_arr[body_nodes[0]])
        ks = np.arange(head, dtype=np.int64)
        if cfg.overhang == OVERHANG_ATTACH:
            cols = np.maximum(0, pfirst - (head - ks))
        else:  # edge
            cols = ks
        mk = qmasks[:head].astype(np.uint8)
        if lowercase_unaligned:
            mk = mk | alphabet.M_LC
        seg_pos.append(cols)
        seg_mask.append(mk)

    # aligned body
    body_cols = pos_arr[body_nodes].astype(np.int64)
    seg_pos.append(body_cols)
    seg_mask.append(qmasks[body_idx].astype(np.uint8))
    if cfg.debug_graph:
        _write_path_svg(
            f"mesh_{query.name}.svg", body_cols, body_idx,
            width, m,
        )
    neg_match = -cfg.match_score
    sum_weight = float(
        (
            neg_match
            * np.asarray(col_weights)[body_cols]
            * np.asarray(w_arr)[body_nodes]
        ).sum()
    )

    # right overhang (mesh.h:594-615)
    if cutoff_tail > 0 and cfg.overhang != OVERHANG_REMOVE:
        mp = int(pos_arr[best_j])
        ts = np.arange(cutoff_tail, dtype=np.int64)
        if cfg.overhang == OVERHANG_ATTACH:
            cols = np.minimum(width - 1, mp + 1 + ts)
        else:  # edge
            cols = width - cutoff_tail + ts
        mk = qmasks[best_i + 1 :].astype(np.uint8)
        if lowercase_unaligned:
            mk = mk | alphabet.M_LC
        seg_pos.append(cols)
        seg_mask.append(mk)

    out = query.copy()
    out.positions = np.concatenate(seg_pos).astype(np.uint32)
    out.masks = np.concatenate(seg_mask).astype(np.uint8)
    out.width = width
    # enforce nondecreasing (overhang clamping can locally violate)
    out.positions = np.maximum.accumulate(out.positions)
    if cfg.insertion == INSERTION_REMOVE:
        log.append("insertion=remove not implemented, using shift;")
    stats = out.fix_duplicate_positions(lowercase=lowercase_unaligned)
    if stats["total_inserts"] > 0:
        log.append(
            f"total inserted bases={stats['total_inserts']};"
            f"longest insertion={stats['longest_insert']};"
        )

    score = raw / sum_weight if sum_weight != 0 else 0.0
    log.append(
        f"scoring: raw={raw:.6g}, weight={sum_weight:.6g}, "
        f"query-len={m}, score={score:.6g};"
    )

    out.set_attr(FN_HEAD, int(cutoff_head))
    out.set_attr(FN_TAIL, int(cutoff_tail))
    out.set_attr(
        FN_QUAL, int(min(100.0, max(0.0, 100.0 * score)))
    )
    out.set_attr(FN_DATE, _now())
    out.set_attr(FN_FILTER, astats_name)
    if cfg.write_used_rels:
        out.set_attr(
            FN_USED_RELS, " ".join(r.name for r in refs)
        )
    if cfg.calc_idty:
        calc = Comparator(
            IUPAC_OPTIMISTIC, "none", COVER_OVERLAP, False
        )
        idty = max(
            (calc(out, r) for r in refs), default=0.0
        )
        out.set_attr(FN_IDTY, 100.0 * idty)
    out.set_attr("align_log_slv", " ".join(log))
    return out
