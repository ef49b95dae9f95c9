"""Native (C++) host data path, loaded via ctypes.

Builds lazily with g++ on first use into the package's git-ignored
``_build`` directory (not next to the source); falls back silently to
the pure-python implementations when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger("sina.native")

_HERE = Path(__file__).parent
_SRC = _HERE / "sinaio.cpp"
_SO = _HERE.parent / "_build" / "libsinaio.so"

_lib = None
_tried = False


def _build() -> bool:
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        # compile to a file of this process's own, then rename: parallel
        # test workers may build at the same time
        tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            [
                # -ffp-contract=off: -O3 defaults to fast contraction;
                # on FMA-baseline targets (aarch64) a fused
                # go_w*gof + ge_w*gef could differ by 1 ulp from
                # numpy's two-rounding f32 order and break the claimed
                # bit-exactness vs _pack_fgq at int16 rounding edges.
                "g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
                "-std=c++17", "-pthread", str(_SRC), "-o", str(tmp),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # no compiler / failed build -> fallback
        logger.info("native build unavailable: %s", e)
        return False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SO.exists() or (
        _SRC.exists()
        and _SO.stat().st_mtime < _SRC.stat().st_mtime
    ):
        if not _build():
            return None
    lib = _load_and_bind()
    if lib is None and _SRC.exists():
        # A stale .so (copied tree / touched file) can pass the mtime
        # check yet miss newer symbols; rebuild once before giving up
        # so one bad timestamp doesn't disable every native path.
        if _build():
            lib = _load_and_bind()
    _lib = lib
    return _lib


def _load_and_bind():
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError as e:
        logger.info("native load failed: %s", e)
        return None
    try:
        _bind(lib)
    except AttributeError as e:
        logger.info("native symbol missing (stale libsinaio.so): %s", e)
        return None
    return lib


def _bind(lib):
    lib.sina_parse_fasta.restype = ctypes.c_long
    lib.sina_parse_fasta.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.uint32),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.uint8),
        ctypes.c_long,
    ]
    lib.sina_fasta_has_comments.restype = ctypes.c_long
    lib.sina_fasta_has_comments.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
    ]
    lib.sina_build_profiles.restype = ctypes.c_long
    lib.sina_build_profiles.argtypes = [
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.sina_build_profiles_packed.restype = ctypes.c_long
    lib.sina_build_profiles_packed.argtypes = [
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.uint8),
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.sina_count_cols.restype = ctypes.c_long
    lib.sina_count_cols.argtypes = [
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.sina_count_cols_range.restype = ctypes.c_long
    lib.sina_count_cols_range.argtypes = [
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.sina_member_ranges.restype = ctypes.c_long
    lib.sina_member_ranges.argtypes = [
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.sina_query_windows.restype = ctypes.c_long
    lib.sina_query_windows.argtypes = [
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
    ]
    lib.sina_score_counts.restype = ctypes.c_long
    lib.sina_score_counts.argtypes = [
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.uint8),
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.sina_score_counts_mq.restype = ctypes.c_long
    lib.sina_score_counts_mq.argtypes = [
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.uint8),
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
    ]
    lib.sina_build_kmer_lists.restype = ctypes.c_long
    lib.sina_build_kmer_lists.argtypes = [
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
    ]
    lib.sina_build_graphs.restype = ctypes.c_long
    lib.sina_build_graphs.argtypes = [
        np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
    ]
    lib.sina_pack_graph.restype = ctypes.c_long
    lib.sina_pack_graph.argtypes = [
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.uint8),
        ctypes.c_long,
    ]
    lib.sina_fill_packed.restype = ctypes.c_long
    lib.sina_fill_packed.argtypes = [
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.uint8),
        ctypes.c_longlong, ctypes.c_long,
    ]
    lib.sina_contains.restype = ctypes.c_long
    lib.sina_contains.argtypes = [
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_long,
    ]


def _n_threads() -> int:
    import os

    return max(1, os.cpu_count() or 1)


def build_kmer_lists(flat_masks, offsets, k: int, fast: bool):
    """Parallel per-sequence unique k-mer extraction (the index-build
    hot path, kmer_search.cpp:152-211's parallel_reduce role).
    Returns (seq_kmers int32, seq_offsets int64) CSR or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_seqs = len(offsets) - 1
    total = int(offsets[-1])
    out_kmers = np.empty(max(total, 1), dtype=np.int32)
    out_offsets = np.empty(n_seqs + 1, dtype=np.int64)
    rc = lib.sina_build_kmer_lists(
        np.ascontiguousarray(flat_masks, np.uint8),
        np.ascontiguousarray(offsets, np.int64),
        n_seqs, k, 1 if fast else 0,
        out_kmers, out_offsets, _n_threads(),
    )
    if rc != 0:
        return None
    return out_kmers[: int(out_offsets[-1])].copy(), out_offsets


def contains_batch(
    flat_mask4, member_starts, member_counts, fam_sizes,
    qmask4_flat, qoffsets,
):
    """Batched subarray containment of each query's case-stripped
    masks in each of its family members' (try_copy_alignment fast
    path).  Returns per-member first-occurrence offsets (int64,
    -1 = not contained) aligned with member_starts order, or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(fam_sizes)
    n_total = len(member_starts)
    out = np.empty(max(n_total, 1), dtype=np.int64)
    rc = lib.sina_contains(
        np.ascontiguousarray(flat_mask4, np.uint8),
        np.ascontiguousarray(member_starts, np.int64),
        np.ascontiguousarray(member_counts, np.int64),
        np.ascontiguousarray(fam_sizes, np.int64),
        np.ascontiguousarray(qmask4_flat, np.uint8),
        np.ascontiguousarray(qoffsets, np.int64),
        B, out, _n_threads(),
    )
    if rc != 0:
        return None
    return out[:n_total]


def pack_graph(preds, is_start, is_end, n_real):
    """Parallel graph-tensor packing (predecessor distance bitmask +
    flag byte); returns (predbits (B,N) int32, flags (B,N) uint8) or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B, N, P = preds.shape
    predbits = np.empty((B, N), np.int32)
    flags = np.empty((B, N), np.uint8)
    rc = lib.sina_pack_graph(
        np.ascontiguousarray(preds, np.int32),
        np.ascontiguousarray(is_start, np.uint8),
        np.ascontiguousarray(is_end, np.uint8),
        np.ascontiguousarray(n_real, np.int64),
        B, N, P,
        predbits, flags, _n_threads(),
    )
    if rc != 0:
        return None
    return predbits, flags


def fill_packed(seq_kmers, seq_offsets, n_seqs: int, P) -> bool:
    """Parallel bitpacked incidence fill: P[kmer, s>>3] |= 1<<(s&7).
    P must be a zeroed C-contiguous (rows, row_bytes) uint8 array.
    Returns False when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    rc = lib.sina_fill_packed(
        np.ascontiguousarray(seq_kmers, np.int32),
        np.ascontiguousarray(seq_offsets, np.int64),
        n_seqs, P, P.shape[1], _n_threads(),
    )
    return rc == 0


def score_counts(
    flat_pos, flat_masks, offsets, ids, qcol_mask,
    q_lo: int, q_hi: int, iupac_rule: int, filter_lc: bool,
):
    """Native comparator counts per candidate: returns (n_ids, 6)
    int64 [match, common, nb, b_in, r_lo, r_hi] or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(ids)
    out = np.zeros((n, 6), dtype=np.int64)
    lib.sina_score_counts(
        np.ascontiguousarray(flat_pos, np.uint32),
        np.ascontiguousarray(flat_masks, np.uint8),
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(ids, np.int64),
        n,
        np.ascontiguousarray(qcol_mask, np.uint8),
        q_lo, q_hi, iupac_rule, 1 if filter_lc else 0,
        out,
    )
    return out


def score_counts_mq(
    flat_pos, flat_masks, offsets, ids, id_offsets,
    qcol_masks, q_lo, q_hi, iupac_rule: int, filter_lc: bool,
):
    """Multi-query comparator counts (threaded over queries):
    returns (id_offsets[-1], 6) int64 rows, or None when the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    qcol_masks = np.ascontiguousarray(qcol_masks, np.uint8)
    n_q = qcol_masks.shape[0]
    out = np.zeros((int(id_offsets[-1]), 6), dtype=np.int64)
    lib.sina_score_counts_mq(
        np.ascontiguousarray(flat_pos, np.uint32),
        np.ascontiguousarray(flat_masks, np.uint8),
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(ids, np.int64),
        np.ascontiguousarray(id_offsets, np.int64),
        n_q,
        qcol_masks, qcol_masks.shape[1],
        np.ascontiguousarray(q_lo, np.int64),
        np.ascontiguousarray(q_hi, np.int64),
        iupac_rule, 1 if filter_lc else 0,
        out, _n_threads(),
    )
    return out


def count_cols(
    all_pos, member_starts, base_counts, fam_sizes, width: int,
):
    """Native occupied-column counts per family over a flat base
    store (the shape-bucketing input of align_dispatch).  Returns
    (B,) int64 or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(fam_sizes)
    out = np.zeros(B, np.int64)
    rc = lib.sina_count_cols(
        np.ascontiguousarray(all_pos, np.uint32),
        np.ascontiguousarray(member_starts, np.int64),
        np.ascontiguousarray(base_counts, np.int64),
        np.ascontiguousarray(fam_sizes, np.int64),
        B, width,
        out,
    )
    if rc != 0:
        return None
    return out


def member_ranges(
    all_pos, member_starts, base_counts, fam_sizes, lo, hi,
):
    """Per-member base subranges covering each family's raw-column
    window [lo, hi) (lo < 0 keeps the member whole).  Returns
    (starts, counts) int64 arrays or None when the native library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(member_starts)
    out_starts = np.empty(n, np.int64)
    out_counts = np.empty(n, np.int64)
    rc = lib.sina_member_ranges(
        np.ascontiguousarray(all_pos, np.uint32),
        np.ascontiguousarray(member_starts, np.int64),
        np.ascontiguousarray(base_counts, np.int64),
        np.ascontiguousarray(fam_sizes, np.int64),
        np.ascontiguousarray(lo, np.int64),
        np.ascontiguousarray(hi, np.int64),
        len(fam_sizes),
        out_starts, out_counts,
    )
    if rc != 0:
        return None
    return out_starts, out_counts


def query_windows(
    qmasks, qoffsets, tbl_vals, tbl_pos, tbl_offsets, tbl_nbases,
    rpos_flat, rpos_offsets, qtable, cols, k: int,
):
    """Batched native query_window (ops/colspan.py semantics):
    returns (B, 3) int64 [lo_col, hi_col, est_ranks] with -1 rows
    for unanchored queries, or None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(qoffsets) - 1
    out = np.empty(B * 3, np.int64)
    rc = lib.sina_query_windows(
        np.ascontiguousarray(qmasks, np.uint8),
        np.ascontiguousarray(qoffsets, np.int64),
        B,
        np.ascontiguousarray(tbl_vals, np.int64),
        np.ascontiguousarray(tbl_pos, np.int64),
        np.ascontiguousarray(tbl_offsets, np.int64),
        np.ascontiguousarray(tbl_nbases, np.int64),
        np.ascontiguousarray(rpos_flat, np.uint32),
        np.ascontiguousarray(rpos_offsets, np.int64),
        np.ascontiguousarray(qtable, np.int64),
        np.ascontiguousarray(cols, np.int64),
        len(cols), k,
        out, _n_threads(),
    )
    if rc != 0:
        return None
    return out.reshape(B, 3)


def count_cols_range(
    all_pos, member_starts, base_counts, fam_sizes, lo, hi,
    width: int,
):
    """Occupied-column counts restricted to per-family raw-column
    windows [lo, hi) — the exact bucketing input for col-trimmed DP
    rows.  Returns (B,) int64 or None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(fam_sizes)
    out = np.zeros(B, np.int64)
    rc = lib.sina_count_cols_range(
        np.ascontiguousarray(all_pos, np.uint32),
        np.ascontiguousarray(member_starts, np.int64),
        np.ascontiguousarray(base_counts, np.int64),
        np.ascontiguousarray(fam_sizes, np.int64),
        np.ascontiguousarray(lo, np.int64),
        np.ascontiguousarray(hi, np.int64),
        B, width,
        out,
    )
    if rc != 0:
        return None
    return out


def build_profiles(
    all_pos, all_mask, member_starts, base_counts, fam_sizes,
    width: int, cpad: int,
):
    """Native batched pseq profile construction over a flat base
    store: each family member's bases live at
    all_pos/all_mask[member_starts[i] : +base_counts[i]] (no
    concatenation/gather needed).  Returns (freqs (B,cpad,4) f32,
    gap_open (B,cpad) f32, gap_ext (B,cpad) f32, cols_flat (B,cpad)
    i32, c_real (B,) i64) or None when the native library is
    unavailable or cpad is too small."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(fam_sizes)
    freqs = np.zeros((B, cpad, 4), np.float32)
    gapo = np.zeros((B, cpad), np.float32)
    gape = np.zeros((B, cpad), np.float32)
    cols_flat = np.zeros((B, cpad), np.int32)
    c_real = np.zeros(B, np.int64)
    rc = lib.sina_build_profiles(
        np.ascontiguousarray(all_pos, np.uint32),
        np.ascontiguousarray(all_mask, np.uint8),
        np.ascontiguousarray(member_starts, np.int64),
        np.ascontiguousarray(base_counts, np.int64),
        np.ascontiguousarray(fam_sizes, np.int64),
        len(base_counts), B, width, cpad,
        freqs, gapo, gape, cols_flat, c_real,
    )
    if rc != 0:
        return None
    return freqs, gapo, gape, cols_flat, c_real


def build_profiles_packed(
    all_pos, all_mask, member_starts, base_counts, fam_sizes,
    width: int, cpad: int,
    gap_open: float, gap_ext: float, gap_scale: float,
):
    """Native batched pseq profile construction emitting the
    device-quantised wire format directly: fgq (B,cpad,6) u8 — bytes
    0-3 rint(freq*255), bytes 4-5 int16 rint(gapcost*gap_scale) —
    bit-exact vs build_profiles + ops/profile._pack_fgq.  Returns
    (fgq, cols_flat (B,cpad) i32, c_real (B,) i64) or None when the
    native library is unavailable or cpad is too small."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sina_build_profiles_packed"):
        return None
    B = len(fam_sizes)
    fgq = np.zeros((B, cpad, 6), np.uint8)
    cols_flat = np.zeros((B, cpad), np.int32)
    c_real = np.zeros(B, np.int64)
    rc = lib.sina_build_profiles_packed(
        np.ascontiguousarray(all_pos, np.uint32),
        np.ascontiguousarray(all_mask, np.uint8),
        np.ascontiguousarray(member_starts, np.int64),
        np.ascontiguousarray(base_counts, np.int64),
        np.ascontiguousarray(fam_sizes, np.int64),
        B, width, cpad,
        fgq, gap_open, gap_ext, gap_scale,
        cols_flat, c_real,
    )
    if rc != 0:
        return None
    return fgq, cols_flat, c_real


def parse_fasta_buffer(data: bytes):
    """Parse a FASTA byte buffer natively.

    Returns list of (name, full_name, positions, masks, width) or
    None when the native path is unavailable/unsuitable (comment
    lines present)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return []
    if lib.sina_fasta_has_comments(data, n):
        return None  # attribute comments: python reader handles them
    max_recs = max(16, data.count(b">") + 1)
    masks = np.empty(n, dtype=np.uint8)
    positions = np.empty(n, dtype=np.uint32)
    base_offsets = np.empty(max_recs + 1, dtype=np.int64)
    widths = np.empty(max_recs, dtype=np.int64)
    header_offsets = np.empty(2 * max_recs, dtype=np.int64)
    flags = np.empty(max_recs, dtype=np.uint8)
    nrec = lib.sina_parse_fasta(
        data, n, masks, positions, n,
        base_offsets, widths, header_offsets, flags, max_recs,
    )
    if nrec < 0:
        return None
    out = []
    for r in range(nrec):
        if flags[r]:
            hdr = data[
                header_offsets[2 * r] : header_offsets[2 * r + 1]
            ].decode("utf-8", "replace")
            logger.error(
                "Skipping sequence >%s (contains invalid character)",
                hdr.split(None, 1)[0] if hdr else "",
            )
            continue
        hdr = data[
            header_offsets[2 * r] : header_offsets[2 * r + 1]
        ].decode("utf-8", "replace")
        parts = hdr.split(None, 1)
        name = parts[0] if parts else ""
        full_name = parts[1] if len(parts) > 1 else None
        lo, hi = int(base_offsets[r]), int(base_offsets[r + 1])
        out.append(
            (
                name,
                full_name,
                positions[lo:hi].copy(),
                masks[lo:hi].copy(),
                int(widths[r]),
            )
        )
    return out
