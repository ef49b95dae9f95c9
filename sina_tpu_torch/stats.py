"""Per-column alignment statistics -> DP column weights.

Port of the semantics of alignment_stats
(SINA src/alignment_stats.cpp:54-132): per column, the
substitution rate is Jukes-Cantor-corrected mutations/bases and the
weight is 0.5 - log(rate), clamped to <= 20; columns covered by fewer
than 20% of taxa weigh 1.

The reference obtains mutation counts from ARB's positional-variability
-by-parsimony SAI.  Bundles may carry exact counts; `estimate_astats`
computes a proxy from the reference MSA itself (mutations ~ bases
disagreeing with the column consensus), which preserves the
conserved-vs-variable weighting signal.
"""

from __future__ import annotations

import numpy as np

from . import alphabet
from .comparator import jukes_cantor


def compute_weights(astat: dict) -> np.ndarray:
    """astat: {'name', 'ntaxa', 'freqs' (W,6) [na,nc,ng,nu,nM,nT]}."""
    freqs = astat["freqs"].astype(np.float64)
    ntaxa = float(astat["ntaxa"])
    bases = freqs[:, 0:4].sum(axis=1)
    n_mut = freqs[:, 4]
    covered = bases > ntaxa * 0.2
    safe_bases = np.maximum(bases, 1.0)
    rate = np.minimum(n_mut / safe_bases, 0.95 * 0.75)
    rate = np.minimum(jukes_cantor(rate), 1.0)
    with np.errstate(divide="ignore"):
        w = 0.5 - np.log(rate)
    w = np.minimum(w, 20.0)
    return np.where(covered, w, 1.0).astype(np.float32)


def family_base_freqs(seqs) -> np.ndarray:
    """Global base frequencies (A, G, C, U) over a set of sequences;
    ambiguity codes split their count over their letters."""
    counts = np.zeros(4, dtype=np.float64)
    for s in seqs:
        m = s.masks & 0xF
        amb = alphabet.AMBIG_ORDER[m].astype(np.float64)
        w = 1.0 / np.maximum(amb, 1)
        for b in range(4):
            counts[b] += w[(m & (1 << b)) != 0].sum()
    total = counts.sum()
    if total <= 0:
        return np.full(4, 0.25)
    return counts / total


def subst_matrix(
    base_freqs: np.ndarray, identity: float
) -> np.ndarray:
    """Log-odds substitution cost matrix (4x4, order A G C U) for the
    experimental --use-subst-matrix scheme.

    The reference's generator is disabled (`#if 0`,
    alignment_stats.cpp:139-160) and returns an uninitialized matrix;
    this implements the formula that code documents:
    m[i,j] = -log(p / (f_i * f_j)) with p = identity/4 on the
    diagonal and (1-identity)/12 off it, so matches score negative
    (reward) and mismatches positive (penalty) in the min-cost DP."""
    f = np.asarray(base_freqs, dtype=np.float64)
    f = np.maximum(f, 1e-4)
    ident = float(np.clip(identity, 1e-3, 1.0 - 1e-3))
    p = np.full((4, 4), (1.0 - ident) / 12.0)
    np.fill_diagonal(p, ident / 4.0)
    return (-np.log(p / np.outer(f, f))).astype(np.float32)


def estimate_astats(db, name: str = "auto:all") -> dict:
    """Build approximate column stats from the bundle's own MSA."""
    width = db.width
    counts = np.zeros((width, 4), dtype=np.int64)  # A C G U
    for s in db.sequences:
        m = s.masks & 0xF
        counts[s.positions[m == alphabet.M_A], 0] += 1
        counts[s.positions[m == alphabet.M_C], 1] += 1
        counts[s.positions[m == alphabet.M_G], 2] += 1
        counts[s.positions[m == alphabet.M_TU], 3] += 1
    bases = counts.sum(axis=1)
    # parsimony proxy: disagreements with column consensus
    n_mut = bases - counts.max(axis=1)
    freqs = np.zeros((width, 6), dtype=np.int64)
    freqs[:, 0] = counts[:, 0]
    freqs[:, 1] = counts[:, 1]
    freqs[:, 2] = counts[:, 2]
    freqs[:, 3] = counts[:, 3]
    freqs[:, 4] = n_mut
    freqs[:, 5] = n_mut // 2
    return {"name": name, "ntaxa": len(db.sequences), "freqs": freqs}
