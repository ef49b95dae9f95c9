"""Column-profile reference ("pseq") — host builders and the device
dispatch of the profile chain DP.

Port of sina_tpu/ops/profile.py.  The host builders (the per-family
``build_profile`` and ``query_profile_weights``, the batched profile
build, native quantised packing) are copied as they are: that module
imports jax, so it cannot be reused by import.  The device half is
torch: ``profile_dp_dispatch`` writes one bucket into one wire buffer
(the JAX package's layout, with aligned segments), uploads it in one
copy, launches the fused DP (ops/profile_kernel.profile_dp) and the
chain traceback on views of it (``profile_dp_wire``; the same on
three separate device arrays is ``profile_dp_result``), and starts the
result's copy to the host (ops/transfer); ``profile_dp_fetch`` waits
for that copy and returns numpy (emit, best_c, best_i, raw);
``profile_dp_batch`` does both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import alphabet
from ..sequence import Sequence
from ..timing import get_timer

from . import transfer
from .align_kernel import DpParams
from .profile_kernel import chain_traceback, gap_scale as _gap_scale, profile_dp

# base order A G C U matching alphabet.BASE_*
_BASE_BITS = np.array(
    [alphabet.M_A, alphabet.M_G, alphabet.M_C, alphabet.M_TU],
    dtype=np.uint8,
)



@dataclass
class Profile:
    """One family's profile (sina_tpu/ops/profile.py:39-49)."""

    cols: np.ndarray     # (C,) int32 occupied alignment columns
    freqs: np.ndarray    # (C, 4) f32 base fractions (sum<=1)
    gap_open: np.ndarray  # (C,) f32 gap-open fraction
    gap_ext: np.ndarray   # (C,) f32 gap-extend fraction
    width: int

    @property
    def n_cols(self) -> int:
        return len(self.cols)


def build_profile(family: list[Sequence]) -> Profile:
    """Column sweep over one family (sina_tpu/ops/profile.py:52-103,
    pseq.cpp:44-115): at each occupied column, 12/ambig points over
    each present base's letters; an absent sequence contributes
    gap-open points if present at the previous occupied column, else
    gap-extend points (12 each).  The oracle of build_profiles_batch."""
    width = family[0].width
    n = len(family)
    for s in family:
        if s.width != width:
            raise ValueError("family sequences differ in width")

    all_pos = np.concatenate([s.positions for s in family])
    all_mask = np.concatenate([s.masks for s in family]) & 0xF
    seq_ids = np.repeat(
        np.arange(n), [len(s.positions) for s in family]
    )
    amb = alphabet.AMBIG_ORDER[all_mask].astype(np.float64)
    w = 12.0 / np.maximum(amb, 1)

    pts = np.zeros((width, 4), dtype=np.float64)
    for b in range(4):
        has = (all_mask & _BASE_BITS[b]) != 0
        pts[:, b] = np.bincount(
            all_pos[has], weights=w[has], minlength=width
        )
    occupied = pts.sum(axis=1) > 0
    cols = np.nonzero(occupied)[0].astype(np.int32)
    C = len(cols)
    col_index = np.full(width, -1, dtype=np.int64)
    col_index[cols] = np.arange(C)

    pres = np.zeros((n, C), dtype=bool)
    pres[seq_ids, col_index[all_pos]] = True
    prev = np.zeros((n, C), dtype=bool)
    prev[:, 1:] = pres[:, :-1]
    gapo = ((~pres) & prev).sum(axis=0).astype(np.float64)
    gape = ((~pres) & ~prev).sum(axis=0).astype(np.float64)

    total = pts[cols].sum(axis=1) + 12.0 * (gapo + gape)
    total = np.maximum(total, 1e-9)
    freqs = (pts[cols] / total[:, None]).astype(np.float32)
    return Profile(
        cols,
        freqs,
        (12.0 * gapo / total).astype(np.float32),
        (12.0 * gape / total).astype(np.float32),
        width,
    )


def query_profile_weights(qmask: np.ndarray) -> np.ndarray:
    """(M, 4) f32: each query base spread over its IUPAC letters
    (sina_tpu/ops/profile.py:383-393; base_profile(base_iupac),
    pseq.h:66-86)."""
    m = qmask & 0xF
    amb = alphabet.AMBIG_ORDER[m].astype(np.float32)
    w = 1.0 / np.maximum(amb, 1)
    out = np.zeros((len(qmask), 4), dtype=np.float32)
    for b in range(4):
        has = (m & _BASE_BITS[b]) != 0
        out[has, b] = w[has]
    return out

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


# the wire's segments start at multiples of this many bytes: the kernels
# read their operands 16 bytes at once, and the device copy of the wire
# starts on an allocation boundary
WIRE_ALIGN = 256


def _wire_layout(B: int, U: int, C: int, M: int, dedup: bool,
                 aspace: bool) -> tuple[dict[str, tuple[int, int]], int]:
    """Byte (offset, length) of each segment of a profile launch's one
    host-to-device buffer, and its total bytes.  The JAX package's
    segments in its order, int32 ones first (its _wire_layout,
    sina_tpu/ops/profile.py:735-748): lens (B, 2) int32 | fam_idx (B,)
    int32 (dedup) | budget (B, C) int32 (aspace) | fgq (U, C, 6) uint8
    | qmask (B, M) uint8; here each starts at a multiple of WIRE_ALIGN
    bytes, the gaps zero."""
    sizes = (("lens", B * 8), ("fam_idx", B * 4 if dedup else None),
             ("budget", B * C * 4 if aspace else None), ("fgq", U * C * 6),
             ("qmask", B * M))
    segs, o = {}, 0
    for name, n in sizes:
        if n is not None:
            segs[name] = (o, n)
            o = -(-(o + n) // WIRE_ALIGN) * WIRE_ALIGN
    return segs, o


def _build_wire(wire: np.ndarray, segs: dict, fg, qmask, lens, fam_idx,
                budget) -> None:
    """Write one launch's inputs into `wire` (uint8, laid out by
    _wire_layout for B_pad rows), padded as the JAX package's dispatch
    pads them (sina_tpu/ops/profile.py:936-964): padding rows of lens
    (1, 1), fam_idx 0 (dedup: they gather unique row 0), budget 0, fgq
    and qmask zero (the rows of fgq past fg's)."""
    B, M = qmask.shape
    B_pad = segs["lens"][1] // 8

    def seg(name, dtype, shape):
        o, n = segs[name]
        return wire[o:o + n].view(dtype).reshape(shape)

    def put(dst, src, fill):
        dst[: len(src)] = src
        dst[len(src):] = fill

    put(seg("lens", np.int32, (B_pad, 2)), lens, 1)
    if fam_idx is not None:
        put(seg("fam_idx", np.int32, (B_pad,)), fam_idx, 0)
    C = fg.shape[1]
    if budget is not None:
        put(seg("budget", np.int32, (B_pad, C)), budget, 0)
    put(seg("fgq", np.uint8, (segs["fgq"][1] // (6 * C), C, 6)), fg, 0)
    put(seg("qmask", np.uint8, (B_pad, M)), qmask, 0)
    ends = sorted(o + n for o, n in segs.values())
    starts = sorted(o for o, _ in segs.values())[1:] + [len(wire)]
    for e, nxt in zip(ends, starts):
        wire[e:nxt] = 0


def _split_wire(wire: torch.Tensor, segs: dict, C: int, M: int):
    """The device's views of the wire's segments: (fgq (U, C, 6) uint8,
    qmask (B, M) uint8, lens (B, 2) int32, fam_idx (B,) int32 or None,
    budget (B, C) int32 or None), by narrow and a reinterpretation of
    the bytes (the JAX package's static slices and bitcasts,
    sina_tpu/ops/profile.py:751-799)."""
    B = segs["lens"][1] // 8

    def seg(name, dtype, shape):
        if name not in segs:
            return None
        o, n = segs[name]
        return wire.narrow(0, o, n).view(dtype).view(shape)

    return (seg("fgq", torch.uint8, (segs["fgq"][1] // (6 * C), C, 6)),
            seg("qmask", torch.uint8, (B, M)), seg("lens", torch.int32, (B, 2)),
            seg("fam_idx", torch.int32, (B,)), seg("budget", torch.int32, (B, C)))


def profile_dp_dispatch(
    fgq: np.ndarray, qmask: np.ndarray, qlen, c_real,
    params: DpParams, device: torch.device, fam_idx=None, budget=None,
):
    """Upload one bucket and launch the profile DP and its traceback
    WITHOUT waiting for them (sina_tpu/ops/profile.py:910-1012, without
    the XLA fallback): fgq (U, C, 6) uint8 quantised profiles, qmask
    (B, M) uint8, qlen/c_real (B,) numpy.  With `fam_idx` (B,) fgq
    holds the U <= B unique profiles and query b aligns against row
    fam_idx[b] (the kernel gathers).  `budget` (B, C) int32, one row
    per query (also under fam_idx), runs the bounded-insertion mode
    (--insertion forbid).  The batch pads to _bucket_rows(B) (see
    _build_wire).  The host writes every input into one wire buffer,
    pinned on a CUDA device, which crosses in one copy; the result's
    copy to the host starts right after the launch.  Returns a handle
    for profile_dp_fetch: (the device result (B_pad, M+3) int32, its
    transfer.Fetch, B)."""
    t = get_timer("ProfileDP")
    device = torch.device(device)
    B, M = qmask.shape
    C = fgq.shape[1]
    B_pad = _bucket_rows(B)
    U = fgq.shape[0] if fam_idx is not None else B_pad
    segs, nbytes = _wire_layout(B_pad, U, C, M, fam_idx is not None,
                                budget is not None)
    with t.section("pack"):
        wire = transfer.host_buffer(nbytes, device)
        lens = np.stack([np.asarray(qlen), np.asarray(c_real)], axis=1)
        _build_wire(wire.numpy(), segs, fgq, qmask, lens, fam_idx, budget)
    with t.section("h2d"):
        wire_d = transfer.upload(wire, device)
        transfer.release(wire, device)
    with t.section("launch"):
        out = profile_dp_wire(wire_d, segs, C, M, params)
        fetch = transfer.fetch_async(out)
    return out, fetch, B


def profile_dp_result(fgq, qmask, lens, params: DpParams, fam_idx=None,
                      budget=None) -> torch.Tensor:
    """The profile DP and its traceback on device-resident inputs (see
    profile_dp), packed as one (B, M+3) int32 result [emit | best_c |
    best_i | raw's bits], one device-to-host copy (unpack_result reads
    it): the direct multi-array entry, the counterpart of the JAX
    package's _profile_pallas_fn."""
    bp, bc, bi, raw = profile_dp(fgq, qmask, lens, params, fam_idx, budget)
    emit = chain_traceback(bp, bc, bi)
    return torch.cat(
        [emit, bc[:, None], bi[:, None], raw.view(torch.int32)[:, None]],
        dim=1,
    )


def profile_dp_wire(wire: torch.Tensor, segs: dict, C: int, M: int,
                    params: DpParams) -> torch.Tensor:
    """profile_dp_result on the segments of one wire buffer already on
    the device (laid out by _wire_layout): the one-wire entry, the
    counterpart of the JAX package's _profile_wire_fn."""
    fg_d, qm_d, lens_d, fi_d, bud_d = _split_wire(wire, segs, C, M)
    return profile_dp_result(fg_d, qm_d, lens_d, params, fi_d, bud_d)


def unpack_result(packed: np.ndarray):
    """A profile_dp_result fetched to the host -> numpy (emit (B, M),
    best_c, best_i, raw)."""
    return (
        packed[:, :-3],
        packed[:, -3],
        packed[:, -2],
        packed[:, -1].copy().view(np.float32),
    )


def profile_dp_fetch(handle):
    """Fetch a profile_dp_dispatch result: numpy (emit (B, M),
    best_c, best_i, raw).  Waits for this launch's copy only."""
    _, fetch, B = handle
    return unpack_result(fetch.result()[:B])


def profile_dp_batch(freqs, gapcost, qmask, qlen, c_real, params: DpParams,
                     budget=None, device: torch.device | str = "cuda"):
    """Synchronous dispatch + fetch of unpacked profiles (freqs (B, C, 4)
    f32, gapcost (B, C) f32; sina_tpu/ops/profile.py:1024-1035), on
    `device`: numpy (emit, best_c, best_i, raw)."""
    return profile_dp_fetch(profile_dp_dispatch(
        _pack_fgq(freqs, gapcost, params), qmask, qlen, c_real, params,
        device, budget=budget,
    ))
