"""Vectorised k-mer extraction.

Semantics follow the reference's streaming generator
(SINA src/kmer.h:46-151): a 2-bit-per-base rolling window
that only yields a k-mer once k consecutive unambiguous bases have been
seen (ambiguity codes reset the window); an optional prefix filter
keeps only k-mers starting with a given base ("fast" mode keeps
A-prefixed k-mers, quartering index size and query work); an optional
uniqueness filter keeps first occurrences.

Here a whole sequence's k-mers are computed as numpy sliding-window
ops instead of a streamed generator.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .. import alphabet

BASE_A = alphabet.BASE_A


def kmers_of_masks(
    masks: np.ndarray,
    k: int,
    prefix_base: int | None = None,
    unique: bool = False,
) -> np.ndarray:
    """Return the valid k-mer values of a base-mask array, in sequence
    order (with multiplicity unless unique=True).

    prefix_base: if given (e.g. BASE_A), keep only k-mers whose first
    base is that base; returned values are then < 4**(k-1).
    """
    n = len(masks)
    if n < k:
        return np.zeros(0, dtype=np.int64)
    idx = alphabet.BASE_INDEX[masks].astype(np.int64)
    ambig = alphabet.AMBIG_ORDER[masks] != 1
    windows = sliding_window_view(idx, k)  # (n-k+1, k)
    powers = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    vals = windows @ powers
    ok = ~sliding_window_view(ambig, k).any(axis=1)
    if prefix_base is not None:
        ok &= idx[: n - k + 1] == prefix_base
        # strip the (constant) prefix bits so values are < 4**(k-1)
        vals = vals % (4 ** (k - 1))
    vals = vals[ok]
    if unique:
        vals = np.unique(vals)
    return vals


def query_kmers_padded(
    mask_list: list[np.ndarray],
    k: int,
    fast: bool = True,
    pad_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Batch k-mer lists for device scoring.

    Returns (kmers[B, L] int32, counts[B] int32) where invalid slots
    are set to the reserved zero row (n_rows, see kmer_index): queries
    keep k-mer multiplicity (kmer_search.cpp:388-401 uses all_kmers /
    prefix_kmers, not the unique variants).
    """
    prefix = BASE_A if fast else None
    lists = [kmers_of_masks(m, k, prefix_base=prefix) for m in mask_list]
    n_rows = 4 ** (k - 1) if fast else 4 ** k
    L = pad_to or max((len(v) for v in lists), default=1)
    L = max(L, 1)
    if pad_to is None:
        # stable shape buckets: a data-dependent L would force a new
        # kernel compile per batch
        L = -(-L // 512) * 512
    out = np.full((len(lists), L), n_rows, dtype=np.int32)
    counts = np.zeros(len(lists), dtype=np.int32)
    for i, v in enumerate(lists):
        m = min(len(v), L)
        out[i, :m] = v[:m]
        counts[i] = m
    return out, counts
