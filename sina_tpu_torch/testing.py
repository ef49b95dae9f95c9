"""Synthetic reference-alignment generator for tests and benchmarks.

The reference's test fixture is a miniature real database
(test_data/ltp_reduced.arb, a git submodule not shipped with the
sources).  We generate an equivalent miniature fixture: sequences are
evolved along a random binary tree with substitutions, deletions and
insertions, tracked directly in alignment-column space so the resulting
MSA is consistent by construction.  Taxonomy strings are derived from
the tree path, giving realistic LCA-classification targets.
"""

from __future__ import annotations

import numpy as np

from .sequence import Sequence
from .refdb import ReferenceDb
from . import alphabet

_BASES = np.array(
    [alphabet.M_A, alphabet.M_G, alphabet.M_C, alphabet.M_TU],
    dtype=np.uint8,
)

_TAX_LEVELS = ["Dom", "Phy", "Cls", "Ord", "Fam", "Gen"]


def _random_base(rng, n):
    return _BASES[rng.integers(0, 4, size=n)]


def _evolve(
    cols: np.ndarray,
    rates: np.ndarray,
    rng: np.random.Generator,
    branch_len: float,
) -> np.ndarray:
    """One branch of evolution on a column-space sequence.

    cols: (W,) uint8 masks, 0 = gap.  rates: per-column relative
    substitution rate.  branch_len scales event probabilities.
    """
    out = cols.copy()
    occupied = np.nonzero(out != 0)[0]
    n = len(occupied)
    if n == 0:
        return out
    # substitutions
    p_sub = np.clip(0.06 * branch_len * rates[occupied], 0, 0.75)
    sub = rng.random(n) < p_sub
    if sub.any():
        out[occupied[sub]] = _random_base(rng, int(sub.sum()))
    # deletions: short runs at variable columns
    p_del = 0.004 * branch_len
    dele = rng.random(n) < p_del * rates[occupied]
    if dele.any():
        out[occupied[dele]] = 0
    # insertions into currently-empty columns
    empty = np.nonzero(out == 0)[0]
    if len(empty):
        p_ins = 0.003 * branch_len
        ins = rng.random(len(empty)) < p_ins
        if ins.any():
            out[empty[ins]] = _random_base(rng, int(ins.sum()))
    return out


_PAIRING = {
    alphabet.M_A: alphabet.M_TU,
    alphabet.M_TU: alphabet.M_A,
    alphabet.M_G: alphabet.M_C,
    alphabet.M_C: alphabet.M_G,
}


def make_reference(
    n_seqs: int = 200,
    n_core: int = 900,
    width: int = 1500,
    seed: int = 1234,
    n_stems: int = 0,
) -> ReferenceDb:
    """Generate a synthetic reference MSA of n_seqs sequences.  With
    n_stems > 0, helix stems are planted (complementary core columns)
    and the bundle carries the pairing vector so the bp score metric
    (cseq::calcPairScore) has signal."""
    rng = np.random.default_rng(seed)
    # root: occupied core columns spread over the width
    core_cols = np.sort(
        rng.choice(width, size=min(n_core, width), replace=False)
    )
    root = np.zeros(width, dtype=np.uint8)
    root[core_cols] = _random_base(rng, len(core_cols))

    pairs = np.zeros(width, dtype=np.int32)
    if n_stems > 0:
        stem_len = 5
        n_half = len(core_cols) // 2
        for _ in range(n_stems):
            a0 = int(rng.integers(0, max(1, n_half - stem_len)))
            b0 = int(
                rng.integers(n_half, len(core_cols) - stem_len)
            )
            for t in range(stem_len):
                i = int(core_cols[a0 + t])
                j = int(core_cols[b0 + stem_len - 1 - t])
                if pairs[i] or pairs[j] or i == 0 or j == 0:
                    continue
                pairs[i], pairs[j] = j, i
                root[j] = _PAIRING[int(root[i]) & 0xF]
    # per-column variability: mostly conserved, some hot columns
    rates = np.where(rng.random(width) < 0.25, 3.0, 0.35)

    # evolve a binary tree until we have n_seqs leaves
    leaves: list[tuple[np.ndarray, list[int]]] = []

    def grow(cols, path, depth):
        if len(leaves) >= n_seqs:
            return
        if depth == 0 or (
            len(leaves) + 2 ** depth > n_seqs and rng.random() < 0.3
        ):
            leaves.append((cols, path))
            return
        for child in range(2):
            blen = float(rng.uniform(0.3, 1.2))
            grow(
                _evolve(cols, rates, rng, blen),
                path + [child],
                depth - 1,
            )

    depth = int(np.ceil(np.log2(max(n_seqs, 2)))) + 2
    while len(leaves) < n_seqs:
        grow(_evolve(root, rates, rng, 0.5), [len(leaves) % 2], depth)
    leaves = leaves[:n_seqs]

    seqs = []
    for i, (cols, path) in enumerate(leaves):
        pos = np.nonzero(cols)[0].astype(np.uint32)
        seq = Sequence(
            f"SEQ{i:05d}",
            pos,
            cols[pos].astype(np.uint8),
            width,
            {},
        )
        # taxonomy from tree path (grouped 1 bit per level)
        labels = []
        acc = 0
        for lvl, name in enumerate(_TAX_LEVELS):
            if lvl < len(path):
                acc = acc * 2 + path[lvl]
            labels.append(f"{name}{acc}")
        seq.attrs["tax_slv"] = ";".join(labels) + ";"
        seq.attrs["acc"] = f"ACC{i:05d}"
        seq.attrs["start"] = "1"
        seq.attrs["stop"] = str(len(pos))
        seq.attrs["version"] = "1"
        seqs.append(seq)
    return ReferenceDb(seqs, width, pairs=pairs)


def make_reference_large(
    n_seqs: int,
    n_core: int = 1450,
    width: int = 50_000,
    seed: int = 1234,
    group: int = 64,
) -> ReferenceDb:
    """SILVA-scale synthetic reference (100k+ seqs, 50k columns).

    The tree generator above is O(width) per tree node and unusable at
    this scale; here a two-level ancestry (root -> n_seqs/group
    ancestors -> leaves) is built vectorised over the ~n_core occupied
    columns only, so cost is O(n_seqs * n_core) regardless of width.
    Taxonomy derives from the ancestor index (group = genus)."""
    rng = np.random.default_rng(seed)
    core_cols = np.sort(
        rng.choice(width, size=min(n_core, width), replace=False)
    ).astype(np.uint32)
    nc = len(core_cols)
    root = _BASES[rng.integers(0, 4, size=nc)]
    rates = np.where(rng.random(nc) < 0.25, 3.0, 0.35)
    # spare (empty) columns adjacent to core columns for insertions
    empty = np.setdiff1d(
        np.arange(width, dtype=np.uint32), core_cols
    )

    n_anc = -(-n_seqs // group)
    # ancestors: substitutions only (vectorised (n_anc, nc))
    p_anc = np.clip(0.10 * rates, 0, 0.6)
    sub = rng.random((n_anc, nc)) < p_anc
    anc = np.broadcast_to(root, (n_anc, nc)).copy()
    anc[sub] = _BASES[rng.integers(0, 4, size=int(sub.sum()))]
    # ancestor deletions: short random knockouts
    anc_keep = rng.random((n_anc, nc)) > 0.01 * rates

    seqs: list[Sequence] = []
    for a in range(n_anc):
        B = min(group, n_seqs - a * group)
        if B <= 0:
            break
        bases = np.broadcast_to(anc[a], (B, nc)).copy()
        p_leaf = np.clip(0.03 * rates, 0, 0.5)
        sub = rng.random((B, nc)) < p_leaf
        bases[sub] = _BASES[rng.integers(0, 4, size=int(sub.sum()))]
        keep = anc_keep[a][None, :] & (
            rng.random((B, nc)) > 0.004 * rates
        )
        n_ins = rng.poisson(2.0, size=B)
        for b in range(B):
            i = a * group + b
            kb = keep[b]
            pos = core_cols[kb]
            msk = bases[b][kb]
            if n_ins[b]:
                icols = rng.choice(
                    empty, size=n_ins[b], replace=False
                ).astype(np.uint32)
                ibase = _BASES[rng.integers(0, 4, size=n_ins[b])]
                pos = np.concatenate([pos, icols])
                msk = np.concatenate([msk, ibase])
                order = np.argsort(pos, kind="stable")
                pos, msk = pos[order], msk[order]
            seq = Sequence(
                f"SEQ{i:06d}", pos.astype(np.uint32),
                msk.astype(np.uint8), width, {},
            )
            labels = []
            acc = 0
            for lvl, name in enumerate(_TAX_LEVELS):
                acc = acc * 2 + ((a >> (len(_TAX_LEVELS) - 1 - lvl)) & 1)
                labels.append(f"{name}{acc}")
            seq.attrs["tax_slv"] = ";".join(labels) + ";"
            seq.attrs["acc"] = f"ACC{i:06d}"
            seq.attrs["start"] = "1"
            seq.attrs["stop"] = str(len(pos))
            seq.attrs["version"] = "1"
            seqs.append(seq)
    return ReferenceDb(seqs, width)


def make_reference_ltp(
    n_seqs: int = 5000,
    n_core: int = 1400,
    width: int = 6000,
    seed: int = 1234,
    level_sub: tuple = (0.46, 0.30, 0.16, 0.08, 0.035, 0.016),
    level_indel: tuple = (2.2, 1.8, 1.5, 1.2, 0.85, 0.55),
    var_frac: float = 0.42,
    cons_rate: float = 0.22,
    n_stems: int = 0,
) -> ReferenceDb:
    """LTP-like hierarchical fixture: the accuracy-regression stand-in
    for the reference's ltp_reduced.arb (~12k real rRNA sequences).

    Properties mirrored from the real database (what the reference's
    accuracy thresholds implicitly depend on,
    SINA tests/accuracy_kmer.test:33-40):
      * high density — most sequences have relatives at ~0.96-0.99
        identity (the realign test asserts avg_idty > 0.96);
      * graded divergence at every level (the fs-msc-max 0.9/0.8/0.7
        degradation curve needs relatives just under each cap);
      * conserved core + variable regions (rates bimodal);
      * indels as short runs in variable regions, with insertions
        drawn from per-site spare-column pools so related sequences
        share insertion columns (NAST behaviour).

    Implemented as a level-by-level vectorised evolution over the
    occupied-column block matrix (O(n_seqs * n_core), independent of
    width).
    """
    rng = np.random.default_rng(seed)
    # columns: core columns + per-gap spare pools for insertions
    spare_per_gap = 2
    stride = width // (n_core + 1)
    if stride < spare_per_gap + 1:
        raise ValueError("width too small for core + spare pools")
    core_cols = (np.arange(n_core) + 1) * stride
    # spare columns directly after each core column
    spare_cols = (
        core_cols[:, None] + 1 + np.arange(spare_per_gap)[None, :]
    )  # (n_core, spare_per_gap)
    # extended column set: interleave core and its spares
    ext_cols = np.concatenate(
        [core_cols[:, None], spare_cols], axis=1
    ).reshape(-1)
    is_core = np.zeros(len(ext_cols), dtype=bool)
    is_core[:: spare_per_gap + 1] = True
    ncx = len(ext_cols)

    root = np.zeros(ncx, dtype=np.uint8)
    root[is_core] = _BASES[rng.integers(0, 4, size=n_core)]
    pairs = np.zeros(width, dtype=np.int32)
    if n_stems > 0:
        cc = core_cols
        stem_len = 5
        half = n_core // 2
        core_ext_idx = np.nonzero(is_core)[0]
        for _ in range(n_stems):
            a0 = int(rng.integers(0, max(1, half - stem_len)))
            b0 = int(rng.integers(half, n_core - stem_len))
            for t in range(stem_len):
                i, j = int(cc[a0 + t]), int(cc[b0 + stem_len - 1 - t])
                if pairs[i] or pairs[j]:
                    continue
                pairs[i], pairs[j] = j, i
                root[core_ext_idx[b0 + stem_len - 1 - t]] = _PAIRING[
                    int(root[core_ext_idx[a0 + t]]) & 0xF
                ]

    # bimodal per-column substitution rates: conserved core (70%),
    # variable regions (30%, clustered in blocks of ~25 columns)
    n_blocks = max(1, n_core // 25)
    block_var = rng.random(n_blocks) < var_frac
    rate_core = np.where(
        block_var[np.minimum(
            np.arange(n_core) // 25, n_blocks - 1
        )],
        1.0,
        cons_rate,
    )
    rates = np.zeros(ncx, dtype=np.float64)
    rates[is_core] = rate_core
    # spares inherit the rate of their core column
    rates[~is_core] = np.repeat(rate_core, spare_per_gap)

    # branching plan: level populations multiply to >= n_seqs
    fanout = []
    total = 1
    for _ in level_sub:
        f = int(np.ceil((n_seqs / total) ** (1.0 / 1)))  # placeholder
        fanout.append(f)
        total *= f
    # recompute a balanced fanout: L-th root of n_seqs per level
    L = len(level_sub)
    f = int(np.ceil(n_seqs ** (1.0 / L)))
    fanout = [f] * L
    # trim the last level so total ≈ n_seqs
    total = f ** L

    pop = np.broadcast_to(root, (1, ncx)).copy()
    for lvl in range(L):
        n_par = pop.shape[0]
        n_child = min(n_par * fanout[lvl], n_seqs)
        parent_of = np.repeat(
            np.arange(n_par), fanout[lvl]
        )[:n_child]
        child = pop[parent_of].copy()
        # substitutions (vectorised): only occupied cells mutate
        p = level_sub[lvl] * rates[None, :]
        sub = (rng.random(child.shape) < p) & (child != 0)
        child[sub] = _BASES[rng.integers(0, 4, size=int(sub.sum()))]
        # indel events: per child, Poisson(level_indel) run events at
        # shared hotspot sites (real rRNA indels concentrate in a few
        # hypervariable regions, so related lineages indel at the SAME
        # columns and distant families still keep register); half
        # deletions, half insertions
        n_ev = rng.poisson(level_indel[lvl], size=n_child)
        var_core = np.nonzero(rate_core > 0.5)[0]
        if lvl == 0:
            hotspots = var_core[
                rng.choice(
                    len(var_core),
                    size=min(30, len(var_core)),
                    replace=False,
                )
            ]
        core_ext_idx = np.nonzero(is_core)[0]
        for c in range(n_child):
            for _ in range(int(n_ev[c])):
                run = 1 + min(int(rng.geometric(0.55)), 5)
                ci = int(hotspots[rng.integers(0, len(hotspots))])
                if rng.random() < 0.5:
                    # deletion: zero `run` consecutive core columns
                    lo = core_ext_idx[ci]
                    hi = core_ext_idx[min(ci + run, n_core - 1)]
                    child[c, lo:hi][is_core[lo:hi]] = 0
                else:
                    # insertion: fill spares after core column ci
                    base = ci * (spare_per_gap + 1) + 1
                    k = min(run, spare_per_gap)
                    child[c, base : base + k] = _BASES[
                        rng.integers(0, 4, size=k)
                    ]
        pop = child
        if pop.shape[0] >= n_seqs:
            pop = pop[:n_seqs]
            if lvl < L - 1:
                # still apply remaining levels' divergence to keep the
                # identity ladder: continue with fanout 1
                fanout = [1] * L
                continue
    pop = pop[:n_seqs]

    seqs = []
    n_final = pop.shape[0]
    # taxonomy from the (balanced) ancestry path
    for i in range(n_final):
        cols = pop[i]
        occ = np.nonzero(cols)[0]
        seq = Sequence(
            f"SEQ{i:05d}",
            ext_cols[occ].astype(np.uint32),
            cols[occ].astype(np.uint8),
            width,
            {},
        )
        labels = []
        idx = i
        path = []
        for lvl in range(L):
            path.append(idx // (f ** (L - 1 - lvl)) % f)
        acc = 0
        for lvl, name in enumerate(_TAX_LEVELS[:L]):
            acc = acc * f + path[lvl]
            labels.append(f"{name}{acc}")
        seq.attrs["tax_slv"] = ";".join(labels) + ";"
        seq.attrs["acc"] = f"ACC{i:05d}"
        seq.attrs["start"] = "1"
        seq.attrs["stop"] = str(len(occ))
        seq.attrs["version"] = "1"
        seqs.append(seq)
    return ReferenceDb(seqs, width, pairs=pairs)


def make_queries(
    db: ReferenceDb,
    n: int = 20,
    seed: int = 99,
    branch_len: float = 0.8,
) -> list[Sequence]:
    """Evolve one extra branch off random reference sequences; the
    returned Sequences carry their true alignment (positions) so tests
    can score realignment accuracy, and attrs['parent'] names the
    origin."""
    rng = np.random.default_rng(seed)
    width = db.width
    rates = np.where(rng.random(width) < 0.25, 3.0, 0.35)
    out = []
    for i in range(n):
        j = int(rng.integers(0, len(db)))
        parent = db.sequences[j]
        cols = np.zeros(width, dtype=np.uint8)
        cols[parent.positions] = parent.masks
        cols = _evolve(cols, rates, rng, branch_len)
        pos = np.nonzero(cols)[0].astype(np.uint32)
        q = Sequence(
            f"QRY{i:04d}", pos, cols[pos].astype(np.uint8), width, {}
        )
        q.attrs["parent"] = parent.name
        out.append(q)
    return out


def with_long_insertion(db: ReferenceDb, length: int, every: int,
                        seed: int) -> ReferenceDb:
    """`db` with `length` empty columns opened in the middle of the
    alignment, which one of every `every` references (0, every, 2 *
    every, ...) fills with random bases, as a family member with a
    length-variable region or an intervening sequence does in real
    16S/18S data.  In the POA graph of a family that holds such a
    member and relatives without it, a node after the site has a
    predecessor more than `length` nodes back: with length >= 32 its
    graph takes the dense route.  Works on this module's databases and
    on the JAX package's alike (it builds its results with the classes
    of the ones it is given)."""
    rng = np.random.default_rng(seed)
    c0 = db.width // 2
    width = db.width + length
    seqs = []
    for k, s in enumerate(db.sequences):
        pos = s.positions.astype(np.int64)
        pos = np.where(pos >= c0, pos + length, pos)
        masks = s.masks.copy()
        if k % every == 0:
            at = int(np.searchsorted(pos, c0))
            pos = np.insert(pos, at, np.arange(c0, c0 + length))
            masks = np.insert(masks, at, _random_base(rng, length))
        attrs = dict(s.attrs)
        if "stop" in attrs:
            attrs["stop"] = str(len(pos))
        seqs.append(type(s)(s.name, pos.astype(np.uint32), masks, width, attrs))

    def shift(c: int) -> int:
        return c + length if c >= c0 else c

    pairs = np.zeros(width if len(db.pairs) else 0, dtype=np.int32)
    for i in np.flatnonzero(db.pairs):
        pairs[shift(int(i))] = shift(int(db.pairs[i]))
    return type(db)(seqs, width, pairs=pairs)


def unaligned_copy(seq: Sequence) -> Sequence:
    """Strip alignment information (what a FASTA query looks like)."""
    n = len(seq.positions)
    return Sequence(
        seq.name,
        np.arange(n, dtype=np.uint32),
        seq.masks.copy(),
        n,
        dict(seq.attrs),
    )


# The realign-accuracy metrics of the reference's show_dist
# (log.cpp:279-325): sps, the exact-IUPAC identity of a realigned query
# with its original alignment, and cpm, the drop in identity with the
# closest family member that realignment causes.
def _sps_idty():
    from .comparator import (COVER_QUERY, IUPAC_EXACT, IUPAC_OPTIMISTIC,
                             Comparator)

    return (Comparator(IUPAC_EXACT, "none", COVER_QUERY, False),
            Comparator(IUPAC_OPTIMISTIC, "none", COVER_QUERY, False))


def _align(finder, queries, engine: str, device, realign: bool = False):
    from .align import AlignerConfig, align_dispatch, align_finalize

    results = finder.process_batch(queries)
    aligned = align_finalize(align_dispatch(
        queries, [r.family if not r.failed else [] for r in results],
        AlignerConfig(engine=engine, realign=realign), device=device))
    return results, aligned


def realign_metrics(db: ReferenceDb, step: int = 62, engine: str = "graph",
                    lqo: bool = True, device="cpu"):
    """Per-query realign metrics of every `step`-th reference realigned
    against `db` in one batch on `device` (the port of
    tests/test_accuracy_multiseed.py _realign_metrics): numpy (sps,
    cpm), a failed query counting sps 0 and cpm 1."""
    from .famfinder import FamFinder, FamFinderConfig

    sps_cmp, idty_cmp = _sps_idty()
    finder = FamFinder(db, FamFinderConfig(
        fs_full_len=1200, fs_req_gaps=1, fs_leave_query_out=lqo), device)
    originals = db.sequences[::step]
    results, aligned = _align(finder, [unaligned_copy(s) for s in originals],
                              engine, device, realign=True)
    spss, cpms = [], []
    for q0, fr, a in zip(originals, results, aligned):
        if a is None:
            spss.append(0.0)
            cpms.append(1.0)
            continue
        spss.append(sps_cmp(q0, a))
        closest, best = None, -1.0
        for _, r in fr.family:
            v = idty_cmp(q0, r)
            if v > best:
                best, closest = v, r
        cpms.append(best - idty_cmp(a, closest) if closest is not None else 0.0)
    return np.array(spss), np.array(cpms)


def align_vs_truth(db: ReferenceDb, queries, truths, engine: str = "graph",
                   device="cpu") -> np.ndarray:
    """sps of each of `queries` aligned against `db` on `device` with the
    short-reference family options (fs_full_len 400) against its true
    alignment in `truths`; 0 for a failed query."""
    from .famfinder import FamFinder, FamFinderConfig

    sps_cmp, _ = _sps_idty()
    finder = FamFinder(db, FamFinderConfig(fs_full_len=400, fs_req_gaps=1), device)
    _, aligned = _align(finder, queries, engine, device)
    return np.array([sps_cmp(t, a) if a is not None else 0.0
                     for t, a in zip(truths, aligned)])


def partial_reads(db: ReferenceDb, seed: int, lo: int = 300, hi: int = 540):
    """The 240-nt mid-gene reads of tests/test_accuracy_multiseed.py:
    40 queries (seed + 2, branch 1.0) cut to alignment positions
    [lo, hi) of their bases, unaligned, with their true alignments
    sliced alike: (reads, truths)."""
    reads, truths = [], []
    for q in make_queries(db, n=40, seed=seed + 2, branch_len=1.0):
        m = q.masks[lo:hi]
        reads.append(Sequence(q.name, np.arange(len(m), dtype=np.uint32), m, len(m), {}))
        truths.append(Sequence(q.name, q.positions[lo:hi], m, q.width, {}))
    return reads, truths


# Backpointer planes for the traceback tests: the profile DP's (C, B, M)
# uint8 cells (bits 0-1 code, bit 2 deletion opened, bit 3 insertion
# opened; ops/profile_kernel.py) and the graph DP's (B, N, M) int16 cells
# (bits 0-1 code, 2-6 match distance, 7-11 deletion distance, 12
# deletion opened, 13 insertion opened; ops/graph_kernel.py), with the
# walks' start cells.  Each case drives the walks over one kind of edge
# of the window the CUDA kernels stage:
#   random          random cells, starts near the far corner
#   deletion_run    a deletion chain of RUN columns (nodes) from the
#                   start, entered from RESOLVE (even rows) or from
#                   DECIDE after an insertion (odd rows)
#   insertion_run   an insertion run of RUN query positions
#   edge_starts     starts on the plane's edges (padding rows start at 0)
#   outside_starts  starts outside the plane: the reads clamp
#   step_cap        a walk that hits the step cap (the graph's done = 0)
#   jumps           (graph) every match and deletion distance 31
#   zero_dist       (graph) match and deletion distance 0 on match cells
# Every graph plane but step_cap's ends its walks without the cap: node 0
# is a start node and deletion distances are >= 1 where a chain can read
# them, so a walk without a step cap (the JAX package's) ends too.
TRACEBACK_CASES = ("random", "deletion_run", "insertion_run", "edge_starts",
                   "outside_starts", "step_cap")
GRAPH_TRACEBACK_CASES = TRACEBACK_CASES + ("jumps", "zero_dist")
# longer than any window the kernels stage (256 columns or nodes, 192
# query positions)
RUN = 320
_EDGE, _MATCH, _DEL, _INS = 0, 1, 2, 3


def _cells(rng, B: int, C: int, M: int) -> dict:
    """Random cell fields (B, C, M): mostly matches, a rare edge code
    (so walks run far), open flags at 0.35, match distances mostly 1
    and deletion distances mostly 1-3, one in ten up to 31."""
    shape = (B, C, M)
    u = rng.random(shape)
    code = np.where(u < 0.0005, _EDGE, np.where(u < 0.62, _MATCH,
                    np.where(u < 0.81, _DEL, _INS))).astype(np.int32)
    mdist = np.where(rng.random(shape) < 0.9, 1, rng.integers(0, 32, shape))
    ddist = np.where(rng.random(shape) < 0.9, rng.integers(1, 4, shape),
                     rng.integers(1, 32, shape))
    return {"code": code, "dopen": rng.random(shape) < 0.35,
            "iopen": rng.random(shape) < 0.35,
            "mdist": mdist.astype(np.int32), "ddist": ddist.astype(np.int32)}


def _traceback_case(case: str, seed: int, B: int, C: int, M: int, graph: bool):
    """Cell fields (B, C, M), start flags (B, C) and starts (B,) x 2 of
    one case; C counts columns or nodes."""
    if case not in (GRAPH_TRACEBACK_CASES if graph else TRACEBACK_CASES):
        raise ValueError(f"unknown traceback case {case!r}")
    rng = np.random.default_rng(seed)
    f = _cells(rng, B, C, M)
    start = rng.random((B, C)) < 0.002
    start[:, 0] = True
    sj = C - 1 - rng.integers(0, C // 10 + 1, B)
    si = M - 1 - rng.integers(0, M // 10 + 1, B)
    if case == "deletion_run":
        n = min(RUN, C - 2)
        for b in range(B):
            j0, i0 = int(sj[b]), max(int(si[b]), 2)
            si[b] = i0
            if b % 2:       # entered from DECIDE: an insertion, then the run
                f["code"][b, j0, i0], f["iopen"][b, j0, i0] = _INS, True
                i0 -= 1
            f["code"][b, j0, i0] = _DEL
            lo = max(j0 - n, 0)
            f["dopen"][b, lo + 1:j0 + 1, i0] = False
            f["dopen"][b, lo, i0] = True
            f["ddist"][b, lo:j0 + 1, i0] = 1
            start[b, lo:j0 + 1] = lo == 0 and np.arange(lo, j0 + 1) == 0
    elif case == "insertion_run":
        n = min(RUN, M - 2)
        for b in range(B):
            j0, i0 = int(sj[b]), M - 1
            si[b] = i0
            f["code"][b, j0, i0] = _INS
            f["iopen"][b, j0, i0 - n + 1:i0 + 1] = False
            f["iopen"][b, j0, i0 - n] = True
            start[b, j0] = j0 == 0
    elif case == "edge_starts":
        edges = [(C - 1, M - 1), (0, M - 1), (C - 1, 0), (0, 0),
                 (C - 1, None), (None, M - 1), (0, None), (None, 0)]
        for b in range(B):
            ej, ei = edges[b % len(edges)]
            sj[b] = rng.integers(0, C) if ej is None else ej
            si[b] = rng.integers(0, M) if ei is None else ei
    elif case == "outside_starts":
        js = (-3, C + 5, -1, C, C - 1, 0)
        is_ = (M + 7, -2, M, -1, M - 1, M + 1)
        for b in range(B):
            sj[b], si[b] = js[b % len(js)], is_[(b // 2) % len(is_)]
    elif case == "step_cap":
        sj[:], si[:] = C - 1, M - 1
        if graph:       # a deletion chain that never moves nor stops
            f["code"][:], f["ddist"][:] = _DEL, 0
            f["dopen"][:] = start[:] = False
        else:           # two steps a row, then two a column
            f["code"][:], f["iopen"][:] = _INS, True
            f["code"][:, :, 1], f["dopen"][:, :, 1] = _DEL, True
    elif case == "jumps":
        f["mdist"][:], f["ddist"][:] = 31, 31
    elif case == "zero_dist":
        m = f["code"] == _MATCH
        f["mdist"][m], f["ddist"][m], f["dopen"][m] = 0, 0, True
    return f, start, sj.astype(np.int32), si.astype(np.int32)


def chain_traceback_case(case: str, seed: int, B: int, C: int, M: int):
    """A profile-DP backpointer plane and its walks' starts for one of
    TRACEBACK_CASES: bp (C, B, M) uint8, best_c and best_i (B,) int32
    (numpy).  deletion_run needs C > 2, insertion_run M > 2, step_cap
    C >= 12 and M >= 3."""
    f, _, sj, si = _traceback_case(case, seed, B, C, M, graph=False)
    cell = f["code"] | (f["dopen"] << 2) | (f["iopen"] << 3)
    return np.ascontiguousarray(cell.astype(np.uint8).transpose(1, 0, 2)), sj, si


def graph_traceback_case(case: str, seed: int, B: int, N: int, M: int):
    """A graph-DP backpointer plane and its walks' starts for one of
    GRAPH_TRACEBACK_CASES: bp (B, N, M) int16, best_j and best_i (B,)
    int32, flags (B, N) uint8 (bit 0 start node; bits 1-2 random, as
    the end flags the walk ignores) (numpy)."""
    f, start, sj, si = _traceback_case(case, seed, B, N, M, graph=True)
    cell = (f["code"] | (f["mdist"] << 2) | (f["ddist"] << 7)
            | (f["dopen"] << 12) | (f["iopen"] << 13))
    noise = np.random.default_rng(seed + 1).integers(0, 4, (B, N)) << 1
    flags = (start | noise).astype(np.uint8)
    return cell.astype(np.int16), sj, si, flags
