"""Plain reference of the profile engine: the family's column profile,
the chain DP of a query against it, and the DP's traceback.

The semantics are those the JAX package's profile engine defines
(sina_tpu/ops/profile.py and profile_pallas.py, SINA's pseq.cpp:44-115
for the profile): each occupied column of the family holds, per base,
12 points a member base (split over an ambiguity code's letters), and
12 gap-open points for a member absent there but present at the
previous occupied column, 12 gap-extend points otherwise; the profile
travels quantised (a frequency byte x/255 a base, the gap cost
5 x open + 2 x extend fraction as int16 x 32000/7).  The DP minimises
(match -2, mismatch 1 scaled by the profile, gap open 5, extend 2)
over a semi-global lattice of query positions x profile columns,
column by column in float32, in the order of operations the kernel
was specified with, so that a float32 run gives the kernel's bits.
`dtype` runs the same arithmetic in another precision (the control).

Plain PyTorch and NumPy; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

GAP_OPEN, GAP_EXT, MATCH, MISMATCH = 5.0, 2.0, -2.0, 1.0
BIG = 1e6
CODE_EDGE, CODE_MATCH, CODE_DEL, CODE_INS = 0, 1, 2, 3


def gap_scale() -> float:
    return 32000.0 / max(GAP_OPEN + GAP_EXT, 1.0)


def build_profile(members: list[tuple[np.ndarray, np.ndarray]]):
    """(fgq (C, 6) uint8 quantised profile, cols (C,) int64 occupied
    columns) of a family given as [(positions, masks)]."""
    all_pos = np.concatenate([p for p, _ in members]).astype(np.int64)
    all_mask = np.concatenate([m for _, m in members]) & 0xF
    nm = len(members)
    cols = np.unique(all_pos[all_mask != 0])
    C = len(cols)
    ci = np.searchsorted(cols, all_pos)
    pts = np.zeros((C, 4), dtype=np.float64)
    amb = np.array([bin(m).count("1") for m in range(16)], dtype=np.float64)
    w = 12.0 / np.maximum(amb[all_mask], 1)
    for b in range(4):
        has = (all_mask & (1 << b)) != 0
        pts[:, b] = np.bincount(ci[has], weights=w[has], minlength=C)
    present = np.zeros(C, dtype=np.int64)
    gapo = np.zeros(C, dtype=np.int64)
    off = 0
    for p, m in members:
        k = ci[off:off + len(p)][(m & 0xF) != 0]
        off += len(p)
        np.add.at(present, k, 1)
        if len(k):
            # a gap opens after every base whose successor is not at the
            # next occupied column, and after the last base
            nxt = np.append(k[1:], -1)
            opens = k[(nxt != k + 1) & (k + 1 < C)]
            np.add.at(gapo, opens + 1, 1)
    go = gapo.astype(np.float64)
    ge = (nm - present).astype(np.float64) - go
    total = pts[:, 0] + pts[:, 1] + pts[:, 2] + pts[:, 3] + 12.0 * (go + ge)
    total = np.maximum(total, 1e-9)
    f = (pts / total[:, None]).astype(np.float32)
    gof = (12.0 * go / total).astype(np.float32)
    gef = (12.0 * ge / total).astype(np.float32)
    fgq = np.empty((C, 6), dtype=np.uint8)
    fgq[:, :4] = np.rint(f * np.float32(255.0)).astype(np.int64)
    gc = np.float32(GAP_OPEN) * gof + np.float32(GAP_EXT) * gef
    gi = np.rint(gc * np.float32(gap_scale())).astype(np.int16)
    fgq[:, 4:6] = gi.view(np.uint8).reshape(C, 2)
    return fgq, cols


def _shift(x: torch.Tensor, n: int, fill: torch.Tensor) -> torch.Tensor:
    return torch.cat([fill.expand(x.shape[0], n), x[:, :-n]], dim=1)


def chain_dp(fgq: torch.Tensor, qmask: torch.Tensor, ql: torch.Tensor, cr: torch.Tensor,
             dtype=torch.float32):
    """The DP over a batch: fgq (B, C, 6) uint8, qmask (B, M) uint8,
    ql/cr (B,) query lengths and profile columns.  Returns (bp (C, B, M)
    uint8 backpointers: bits 0-1 the move, bit 2 deletion opened, bit 3
    insertion opened; best_c, best_i (B,) int64; raw (B,) float)."""
    dev = qmask.device

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    go, ge = c(GAP_OPEN), c(GAP_EXT)
    m_mm, mm = c(MATCH - MISMATCH), c(MISMATCH)
    big, one, zero = c(BIG), c(1.0), c(0.0)
    fq = fgq[..., :4].to(dtype) * c(1.0 / 255.0)
    gq = fgq[..., 4:6].contiguous().view(torch.int16)[..., 0]
    gc = gq.to(dtype) * c(1.0 / gap_scale())
    B, M = qmask.shape
    C = fgq.shape[1]
    qm = qmask.to(torch.int32) & 0xF
    qbits = [((qm >> k) & 1).to(dtype) for k in range(4)]
    cnt = (qbits[0] + qbits[1]) + qbits[2] + qbits[3]
    inv = torch.where(cnt > 0, one / torch.maximum(cnt, one), zero)
    qs = cnt * inv
    w = [qb * inv for qb in qbits]
    occ = fq[..., 0] + fq[..., 1] + fq[..., 2] + fq[..., 3]
    dgo, dge, mmocc = go * occ, ge * occ, mm * occ
    ql2, cr2 = ql[:, None], cr[:, None]
    lane = torch.arange(M, device=dev)
    flane = lane.to(dtype)
    ramp1 = (flane + 1.0) * ge
    ramp = flane * ge
    base_first = torch.full((B, M), 1.0, dtype=dtype, device=dev)
    base_rest = torch.where(lane == 0, one, big).expand(B, M)
    big1 = big.reshape(1, 1)
    Vp = torch.full((B, M), BIG, dtype=dtype, device=dev)
    Dp = Vp.clone()
    b1v = torch.full((B,), BIG, dtype=dtype, device=dev)
    b1j = torch.zeros(B, dtype=torch.int64, device=dev)
    b2v = b1v.clone()
    b2i = torch.zeros(B, dtype=torch.int64, device=dev)
    bp = torch.empty((C, B, M), dtype=torch.uint8, device=dev)
    for j in range(C):
        f = fq[:, j, :]
        dot = (f[:, 0:1] * w[0] + f[:, 1:2] * w[1] + f[:, 2:3] * w[2] + f[:, 3:4] * w[3])
        sub = m_mm * dot + mmocc[:, j:j + 1] * qs + gc[:, j:j + 1]
        sub = torch.where(j >= cr2, big, sub)
        base = base_first if j == 0 else base_rest
        d_open = Vp + dgo[:, j:j + 1]
        d_ext = Dp + dge[:, j:j + 1]
        dmin = torch.minimum(d_open, d_ext)
        dsel_open = d_open < d_ext
        Drow = torch.minimum(base, dmin)
        Mc = _shift(Vp, 1, big1) + sub
        take_d = dmin < base
        U = torch.where(take_d, dmin, base)
        code = torch.where(take_d, CODE_DEL, CODE_EDGE)
        take_m = Mc < U
        U = torch.where(take_m, Mc, U)
        code = torch.where(take_m, CODE_MATCH, code)
        # insertion track: a prefix minimum along the query
        x = U + go - ramp1
        n = 1
        while n < M:
            x = torch.minimum(x, _shift(x, n, big1))
            n *= 2
        Irow = torch.minimum(_shift(x, 1, big1), one) + ramp
        ins_opened = (_shift(U, 1, big1) + go) <= (_shift(Irow, 1, big1) + ge)
        take_i = Irow <= U
        Vrow = torch.where(take_i, Irow, U)
        code = torch.where(take_i, CODE_INS, code)
        bp[j] = (code | (dsel_open.to(torch.int64) << 2)
                 | (ins_opened.to(torch.int64) << 3)).to(torch.uint8)
        # the end: the last query base at the best column, or the best
        # query position at the last column
        val1 = torch.where(lane == ql2 - 1, Vrow, big).amin(dim=1)
        upd1 = (j < cr) & (val1 < b1v)
        b1v = torch.where(upd1, val1, b1v)
        b1j = torch.where(upd1, j, b1j)
        c2row = torch.where(lane < ql2, Vrow, big)
        v2 = c2row.amin(dim=1)
        i2 = torch.where(c2row == v2[:, None], lane, M).amin(dim=1)
        upd2 = j == cr - 1
        b2v = torch.where(upd2, v2, b2v)
        b2i = torch.where(upd2, i2, b2i)
        Vp, Dp = Vrow, Drow
    use2 = b2v < b1v
    best_c = torch.where(use2, cr - 1, b1j)
    best_i = torch.where(use2, b2i, ql - 1)
    raw = torch.where(use2, b2v, b1v)
    return bp, best_c, best_i, raw


_RESOLVE, _CHAIN, _DECIDE, _INS, _CHAIN_NE, _DONE = 0, 1, 2, 3, 5, 6


def traceback(bp_b: np.ndarray, j: int, i: int) -> np.ndarray:
    """One query's walk back from (column j, base i) through its (C, M)
    backpointers: emit[i] is the profile column that took base i (-1:
    none).  Deletion runs are walked to where they opened, insertion
    runs to where they opened."""
    C, M = bp_b.shape
    emit = np.full(M, -1, dtype=np.int64)
    state = _RESOLVE
    for _ in range(C + 2 * M + 8):
        if state == _DONE:
            break
        cell = int(bp_b[min(max(j, 0), C - 1), min(max(i, 0), M - 1)])
        code = cell & 3
        at_edge = i == 0 or j == 0
        ei, ej = -1, j
        if state == _RESOLVE:
            is_del = code == CODE_DEL and not at_edge
            state = _CHAIN if is_del else _DECIDE
            ei = -1 if is_del else i
        elif state in (_CHAIN, _CHAIN_NE):
            pj = max(j - 1, 0)
            if (cell >> 2) & 1 or pj == 0:
                state = _RESOLVE if state == _CHAIN else _DECIDE
            j = pj
        elif state == _DECIDE:
            if at_edge or code == CODE_EDGE:
                state = _DONE
            elif code == CODE_MATCH:
                j, i = j - 1, i - 1
                state = _RESOLVE
            else:
                state = _INS if code == CODE_INS else _CHAIN_NE
        else:
            ni = i - 1
            i = max(ni, 0)
            if ni < 0:
                state = _DONE
            else:
                state = _DECIDE if (cell >> 3) & 1 else _INS
                ei = i
        if 0 <= ei < M:
            emit[ei] = ej
    return emit
