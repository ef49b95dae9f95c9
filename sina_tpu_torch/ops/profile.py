"""Column-profile reference ("pseq") — host builders and the device
dispatch of the profile chain DP.

Port of sina_tpu/ops/profile.py.  The host builders (batched profile
build, native quantised packing) are copied as they are: that module
imports jax, so it cannot be reused by import.  The device half is
torch: ``profile_dp_dispatch`` uploads one bucket, launches the fused
DP (ops/profile_kernel.profile_dp) and the chain traceback, and
returns a handle that ``profile_dp_fetch`` turns into numpy
(emit, best_c, best_i, raw).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import alphabet
from ..sequence import Sequence
from ..timing import get_timer

from .align_kernel import DpParams
from .profile_kernel import chain_traceback, gap_scale as _gap_scale, profile_dp

# base order A G C U matching alphabet.BASE_*
_BASE_BITS = np.array(
    [alphabet.M_A, alphabet.M_G, alphabet.M_C, alphabet.M_TU],
    dtype=np.uint8,
)


def _gather_family_arrays(seqs: list[Sequence]):
    """Fast path: when every sequence carries a `_flat_ref` stamp into
    the same shared flat arrays (ReferenceDb.ensure_flat), gather the
    concatenated (positions, masks&0xF, lengths) with one fancy index
    instead of concatenating thousands of small arrays
    (sina_tpu/ops/profile.py:106-128)."""
    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0]
    if r0 is None:
        return None
    for r, s in zip(refs, seqs):
        if r is None or r[0] is not r0[0] or r[4] is not s.positions:
            return None
    flat_pos, flat_mask = r0[0], r0[1]
    n = len(seqs)
    starts = np.fromiter((r[2] for r in refs), np.int64, n)
    ends = np.fromiter((r[3] for r in refs), np.int64, n)
    lens = ends - starts
    total = int(lens.sum())
    idx = np.arange(total, dtype=np.int64)
    shift = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=shift[1:])
    idx += np.repeat(starts - shift, lens)
    return flat_pos[idx], flat_mask[idx], lens


def build_profiles_batch(
    families: list[list[Sequence]], cpad: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[np.ndarray]]:
    """Batched pseq profile build over many families at once
    (sina_tpu/ops/profile.py:131-277).  Returns (freqs (B, cpad, 4)
    f32, gap_open (B, cpad) f32, gap_ext (B, cpad) f32, cols:
    per-family occupied column arrays)."""
    from .. import native

    B = len(families)
    width = families[0][0].width
    fam_sizes = np.array([len(f) for f in families], dtype=np.int64)
    seqs = [s for f in families for s in f]
    n_total = len(seqs)

    def _unpack_native(nat):
        freqs, gapo_out, gape_out, cols_flat, c_real = nat
        cols_list = [
            cols_flat[b, : int(c_real[b])] for b in range(B)
        ]
        return freqs, gapo_out, gape_out, cols_list

    # fastest path: C++ builder reading straight out of the shared
    # flat base store (_flat_ref stamps from ReferenceDb.ensure_flat)
    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0] if refs else None
    if r0 is not None and all(
        r is not None and r[0] is r0[0] and r[4] is s.positions
        for r, s in zip(refs, seqs)
    ):
        starts = np.fromiter((r[2] for r in refs), np.int64, n_total)
        ends = np.fromiter((r[3] for r in refs), np.int64, n_total)
        nat = native.build_profiles(
            r0[0], r0[1], starts, ends - starts, fam_sizes,
            width, cpad,
        )
        if nat is not None:
            return _unpack_native(nat)

    fast = _gather_family_arrays(seqs) if seqs else None
    if fast is not None:
        all_pos, all_mask, base_counts = fast
    else:
        base_counts = np.array(
            [len(s.positions) for s in seqs], dtype=np.int64
        )
        all_pos = (
            np.concatenate([s.positions for s in seqs])
            if seqs
            else np.zeros(0, np.int64)
        ).astype(np.int64)
        all_mask = (
            np.concatenate([s.masks for s in seqs])
            if seqs
            else np.zeros(0, np.uint8)
        ) & 0xF
    starts = np.zeros(n_total, dtype=np.int64)
    np.cumsum(base_counts[:-1], out=starts[1:])
    nat = native.build_profiles(
        all_pos, all_mask, starts, base_counts, fam_sizes,
        width, cpad,
    )
    if nat is not None:
        return _unpack_native(nat)

    fam_of_seq = np.repeat(np.arange(B), fam_sizes)
    seq_of_base = np.repeat(np.arange(n_total), base_counts)
    fam_of_base = fam_of_seq[seq_of_base]
    gpos = fam_of_base * width + all_pos  # globalised columns

    amb = alphabet.AMBIG_ORDER[all_mask].astype(np.float64)
    w = 12.0 / np.maximum(amb, 1)
    pts = np.zeros((B * width, 4), dtype=np.float64)
    for b4 in range(4):
        has = (all_mask & _BASE_BITS[b4]) != 0
        pts[:, b4] = np.bincount(
            gpos[has], weights=w[has], minlength=B * width
        )
    pts = pts.reshape(B, width, 4)
    occupied = pts.sum(axis=2) > 0              # (B, width)

    cols_list = []
    col_index = np.full((B, width), -1, dtype=np.int64)
    c_real = np.zeros(B, dtype=np.int64)
    for b in range(B):
        cols = np.nonzero(occupied[b])[0]
        cols_list.append(cols.astype(np.int32))
        col_index[b, cols] = np.arange(len(cols))
        c_real[b] = len(cols)

    # per-member presence/transition counts, bincount-style
    # (pseq.cpp:71-100 semantics: absent at col c = gap-open if the
    # member is present at col c-1, else gap-extend)
    ci = col_index[fam_of_base, all_pos]        # occupied-col index
    nb = len(ci)
    present = np.bincount(
        fam_of_base * cpad + ci, minlength=B * cpad
    ).reshape(B, cpad)
    # a gap OPENS at ci+1 whenever this member's next base is not at
    # the adjacent occupied column (or this is its last base)
    nxt = np.empty(nb, dtype=np.int64)
    if nb:
        nxt[:-1] = ci[1:]
        nxt[-1] = -2
    same = np.zeros(nb, dtype=bool)
    if nb > 1:
        same[:-1] = seq_of_base[1:] == seq_of_base[:-1]
    event = (ci + 1 < c_real[fam_of_base]) & (
        ~same | (nxt != ci + 1)
    )
    gapo = (
        np.bincount(
            fam_of_base[event] * cpad + ci[event] + 1,
            minlength=B * cpad,
        )
        .reshape(B, cpad)
        .astype(np.float64)
    )
    colid = np.arange(cpad)[None, :]
    valid = colid < c_real[:, None]
    absent = np.where(valid, fam_sizes[:, None] - present, 0)
    gape = absent - gapo

    freqs = np.zeros((B, cpad, 4), dtype=np.float32)
    gapo_out = np.zeros((B, cpad), dtype=np.float32)
    gape_out = np.zeros((B, cpad), dtype=np.float32)
    for b in range(B):
        C = int(c_real[b])
        p = pts[b, cols_list[b]]                  # (C, 4)
        total = p.sum(axis=1) + 12.0 * (
            gapo[b, :C] + gape[b, :C]
        )
        total = np.maximum(total, 1e-9)
        freqs[b, :C] = (p / total[:, None]).astype(np.float32)
        gapo_out[b, :C] = (12.0 * gapo[b, :C] / total).astype(
            np.float32
        )
        gape_out[b, :C] = (12.0 * gape[b, :C] / total).astype(
            np.float32
        )
    return freqs, gapo_out, gape_out, cols_list


def can_window_batch(families: list[list[Sequence]]) -> bool:
    """True when window-restricted building is available for these
    families: native lib present + every member stamped into one
    shared flat store (sina_tpu/ops/profile.py:280-294)."""
    from .. import native

    if native.get_lib() is None:
        return False
    seqs = [s for f in families for s in f]
    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0] if refs else None
    return r0 is not None and all(
        r is not None and r[0] is r0[0] and r[4] is s.positions
        for r, s in zip(refs, seqs)
    )


def build_profiles_packed_batch(
    families: list[list[Sequence]], cpad: int, params: DpParams,
    windows: list[tuple[int, int] | None] | None = None,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """build_profiles_batch emitting the device format directly:
    fgq (B, cpad, 6) uint8 (see _pack_fgq) + per-family occupied
    column arrays (sina_tpu/ops/profile.py:297-380, including its
    documented one-column edge deviation of windowed builds)."""
    from .. import native

    B = len(families)
    width = families[0][0].width
    fam_sizes = np.array([len(f) for f in families], dtype=np.int64)
    seqs = [s for f in families for s in f]
    n_total = len(seqs)

    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0] if refs else None
    if r0 is not None and all(
        r is not None and r[0] is r0[0] and r[4] is s.positions
        for r, s in zip(refs, seqs)
    ):
        starts = np.fromiter((r[2] for r in refs), np.int64, n_total)
        ends = np.fromiter((r[3] for r in refs), np.int64, n_total)
        counts = ends - starts
        if windows is not None:
            lo = np.array(
                [-1 if w is None else w[0] for w in windows],
                np.int64,
            )
            hi = np.array(
                [-1 if w is None else w[1] for w in windows],
                np.int64,
            )
            sliced = native.member_ranges(
                r0[0], starts, counts, fam_sizes, lo, hi
            )
            if sliced is None:
                raise RuntimeError(
                    "windowed profile build requested without "
                    "native support (check can_window_batch first)"
                )
            starts, counts = sliced
        nat = native.build_profiles_packed(
            r0[0], r0[1], starts, counts, fam_sizes,
            width, cpad,
            params.gap_open, params.gap_ext, _gap_scale(params),
        )
        if nat is not None:
            fgq, cols_flat, c_real = nat
            return fgq, [
                cols_flat[b, : int(c_real[b])] for b in range(B)
            ]
    if windows is not None:
        raise RuntimeError(
            "windowed profile build requested without native "
            "support (check can_window_batch first)"
        )

    freqs, gapo, gape, cols_list = build_profiles_batch(
        families, cpad
    )
    gapcost = (
        params.gap_open * gapo + params.gap_ext * gape
    ).astype(np.float32)
    return _pack_fgq(freqs, gapcost, params), cols_list


def _pack_fgq(freqs, gapcost, params: DpParams) -> np.ndarray:
    """Quantised profile transfer (sina_tpu/ops/profile.py:519-534):
    (B, C, 6) uint8 = 4 bytes of freqs (x255 fixed point) + 2 bytes
    of gap cost (int16 fixed point)."""
    B, C = gapcost.shape
    fgq = np.empty((B, C, 6), dtype=np.uint8)
    np.rint(
        np.asarray(freqs) * 255.0, out=fgq[:, :, :4],
        casting="unsafe",
    )
    gi = np.rint(
        np.asarray(gapcost) * _gap_scale(params)
    ).astype(np.int16)
    fgq[:, :, 4:6] = gi.view(np.uint8).reshape(B, C, 2)
    return fgq


def _bucket_rows(n: int) -> int:
    """Batch-axis bucket (sina_tpu/ops/profile.py:859-870): powers of
    two, min 16; padded rows are cheap next to a new shape."""
    b = 16
    while b < n:
        b *= 2
    return b


def profile_dp_dispatch(
    fgq: np.ndarray, qmask: np.ndarray, qlen, c_real,
    params: DpParams, device: torch.device, fam_idx=None, budget=None,
):
    """Upload one bucket and launch the profile DP and its traceback
    WITHOUT fetching (sina_tpu/ops/profile.py:910-1012, without the
    TPU wire buffer and the XLA fallback): fgq (U, C, 6) uint8
    quantised profiles, qmask (B, M) uint8, qlen/c_real (B,) numpy.
    With `fam_idx` (B,) fgq holds the U <= B unique profiles and
    query b aligns against row fam_idx[b] (the kernel gathers).
    `budget` (B, C) int32, one row per query (also under fam_idx),
    runs the bounded-insertion mode (--insertion forbid).  The batch
    pads to _bucket_rows(B) with rows of lens (1, 1) and zero budgets;
    dedup padding rows gather unique row 0.  Returns a handle for
    profile_dp_fetch."""
    t = get_timer("ProfileDP")
    dedup = fam_idx is not None
    with t.section("pack"):
        fg = fgq
        M = qmask.shape[1]
        lens = np.stack(
            [np.asarray(qlen), np.asarray(c_real)], axis=1
        ).astype(np.int32)
        B = qmask.shape[0]
        B_pad = _bucket_rows(B)
        if B_pad != B:
            pad = B_pad - B
            if dedup:
                fam_idx = np.concatenate(
                    [np.asarray(fam_idx, np.int32),
                     np.zeros(pad, np.int32)]
                )
            else:
                fg = np.concatenate(
                    [fg, np.zeros((pad,) + fg.shape[1:], fg.dtype)]
                )
            qmask = np.concatenate(
                [qmask,
                 np.zeros((pad, M), dtype=np.asarray(qmask).dtype)]
            )
            lens = np.concatenate(
                [lens, np.ones((pad, 2), dtype=np.int32)]
            )
            if budget is not None:
                budget = np.concatenate(
                    [budget, np.zeros((pad, fg.shape[1]), dtype=np.int32)]
                )
    with t.section("h2d"):
        def up(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=dtype)
            ).to(device)

        fg_d = up(fg, np.uint8)
        qm_d = up(qmask, np.uint8)
        lens_d = up(lens, np.int32)
        fi_d = up(fam_idx, np.int32) if dedup else None
        bud_d = up(budget, np.int32) if budget is not None else None
    with t.section("launch"):
        bp, bc, bi, raw = profile_dp(fg_d, qm_d, lens_d, params, fi_d, bud_d)
        emit = chain_traceback(bp, bc, bi)
        # one (B_pad, M+3) int32 result = one device-to-host copy
        out = torch.cat(
            [emit, bc[:, None], bi[:, None],
             raw.view(torch.int32)[:, None]],
            dim=1,
        )
    return out, B


def profile_dp_fetch(handle):
    """Fetch a profile_dp_dispatch result: numpy (emit (B, M),
    best_c, best_i, raw)."""
    out, B = handle
    packed = out.cpu().numpy()[:B]
    emit = packed[:, :-3]
    return (
        emit,
        packed[:, -3],
        packed[:, -2],
        packed[:, -1].copy().view(np.float32),
    )
