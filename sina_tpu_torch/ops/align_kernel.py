"""Constants and parameters shared by the alignment DPs
(sina_tpu/ops/align_kernel.py:47-63), and the dense-predecessor route
of the graph engine.

The dense route ports the reference's XLA graph core poa_dp_costs with
its three cost set-ups (poa_dp, poa_dp_forbid, poa_dp_subst),
_windowed_min and traceback_device (sina_tpu/ops/align_kernel.py:70-229,
231-258, 409-545, 549-606, 616-714).  ``graph_dp_dense`` launches
csrc/graph_dense.cu's DP for CUDA tensors and runs the plain version
``poa_dp_dense`` (batched torch code, a loop over the nodes) for CPU
tensors; ``graph_traceback_dense`` launches its walk or runs
``traceback_dense``.  The reference runs a bucket whose largest
predecessor distance is 32 or more through this core on every backend
(sina_tpu/align.py:1051, 1084-1105): the graph kernel's 5-bit distance
fields cannot carry such distances.  The families of testing's
generators stay below 32 (8-18), but one family member with an indel
of about 32 columns against relatives that have bases there reaches
it (testing.with_long_insertion makes such members).  The dispatcher
chooses the route by shape before any launch; it is not a fallback
for a kernel that failed.  Its backpointers are slot-coded:

  bits 0-1  V choice: 0=edge, 1=match, 2=deletion, 3=insertion
  bits 2-4  match predecessor slot
  bits 5-7  deletion predecessor slot
  bit  8    deletion opened here
  bit  9    insertion opened here

The host walk ``traceback`` and ``emit_to_pairs`` are the JAX
package's own (sina_tpu/ops/align_kernel.py:608-613, 717-795), the
oracle of the device walk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels

BIG = 1e6

CODE_EDGE = 0
CODE_MATCH = 1
CODE_DEL = 2
CODE_INS = 3

# traceback states (sina_tpu/ops/align_kernel.py:616-623,
# graph_pallas.py:338-339)
_S_RESOLVE, _S_CHAIN, _S_DECIDE, _S_INS = 0, 1, 2, 3
_S_RESOLVE_NE, _S_CHAIN_NE, _S_DONE = 4, 5, 6


@dataclass(frozen=True)
class DpParams:
    """Already-negated scheme values (align.cpp:406: the aligner hands
    -match/-mismatch to the minimising scheme)."""

    match: float = -2.0
    mismatch: float = 1.0
    gap_open: float = 5.0
    gap_ext: float = 2.0


def _shift_right(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    pad = torch.full(x.shape[:-1] + (n,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-n]], dim=-1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32.  The reference's compiled DPs
    contract multiply-adds to fused multiply-adds: the graph kernel
    (graph_dp_pallas_packed, interpret mode) contracts three (Mc, the
    insertion candidate and Irow), the XLA cores the last two (their
    substitution costs are precomputed, so Mc is a plain add); measured
    on the CPU test fixtures.
    The product of two f32 is exact in double, so the double sum
    rounded to f32 is the fused result except where the double sum
    lands exactly on a tie between two floats.  csrc/graph_dp.cu does
    the same double operations, so kernel and plain version agree
    bit for bit."""
    return (a.double() * b.double() + c.double()).float()


def _windowed_min(x: torch.Tensor, R: torch.Tensor, M: int) -> torch.Tensor:
    """Per-row trailing-window minimum out[b, i] = min x[b, i-R[b]+1 .. i]
    over (B, M) rows with a per-row window R (B, 1), BIG standing in
    for lanes before 0 (the aspace-aware insertion budget,
    mesh.h:403-437): sparse-table doubling, the level of the largest
    power of two <= R and one shifted copy of it
    (sina_tpu/ops/align_kernel.py:231-258, graph_pallas.py:79-104).
    Only the levels the widest window needs are built."""
    Rc = torch.clamp(R, 1, M).long()
    smax = int(Rc.max()).bit_length() - 1
    levels = [x]
    for k in range(smax):
        n = 1 << k
        levels.append(torch.minimum(levels[-1], F.pad(levels[-1][:, :-n], (n, 0), value=BIG)))
    s = torch.zeros_like(Rc)
    t_sel = x
    for k in range(1, smax + 1):
        at = Rc >= (1 << k)
        s += at.long()
        t_sel = torch.where(at, levels[k], t_sel)
    idx = torch.arange(M, device=x.device)[None, :] - (Rc - (1 << s))
    b2 = t_sel.gather(1, idx.clamp(min=0)).masked_fill_(idx < 0, BIG)
    return torch.minimum(t_sel, b2)


def _dense_sub(j, mask, qm, subw, match, mismatch, sq, pq):
    """Substitution costs of node j for every query, (B, M): the simple
    or weighted scheme (poa_dp:92-97) or, with sq/pq, the matrix scheme
    (poa_dp_subst:162-182), elementwise in the reference's order."""
    nm = mask[:, j : j + 1]
    if sq is None:
        compat = (nm & qm & 0xF) != 0
        return torch.where(compat, match, mismatch) * subw[:, j : j + 1]
    numer = torch.zeros_like(pq)
    pn = torch.zeros((nm.shape[0], 1), dtype=pq.dtype, device=pq.device)
    for l in range(4):
        bit = ((nm >> l) & 1).to(pq.dtype)
        numer = numer + bit * sq[l]
        pn = pn + bit
    denom = torch.maximum(pn * pq, torch.ones((), dtype=pq.dtype, device=pq.device))
    return (numer / denom) * subw[:, j : j + 1]


def node_costs(pos, weight, col_weights, subst, params: DpParams) -> dict[str, torch.Tensor]:
    """Per-node scalars of the graph DPs (graph_pallas.py:547-580; the
    dense core's poa_dp, poa_dp_forbid and poa_dp_subst compute the same
    values, align_kernel.py:70-229), as (B, N) tensors on the operands'
    device: subw (substitution weight), dgo, dge (deletion open/extend),
    gio, gie (insertion open/extend), in the reference's f32
    operations."""
    f32 = torch.float32
    dev = pos.device
    # made on the device (a copy from the host would wait for the stream)
    go = torch.full((), params.gap_open, dtype=f32, device=dev)
    ge = torch.full((), params.gap_ext, dtype=f32, device=dev)
    W = col_weights.shape[1]
    p = pos.long()
    wcol = torch.gather(col_weights, 1, p)
    if subst is not None:
        # scoring_scheme_matrix: node weights not applied; all gap
        # costs use the node's own column weight (poa_dp_subst)
        return dict(subw=wcol, dgo=go * wcol, dge=ge * wcol,
                    gio=go * wcol, gie=ge * wcol)
    wins = torch.gather(col_weights, 1, torch.clamp(p + 1, max=W - 1))
    return dict(subw=wcol * weight, dgo=go * wcol, dge=ge * wcol,
                gio=go * wins, gie=ge * wins)


def _repeats_previous(planes, nopred) -> list[bool]:
    """same[j]: in every query, node j and node j-1 have no predecessors
    (`nopred`, (B, N) bool) and equal per-node inputs (`planes`, (B, N)
    tensors: costs, mask, flags, budget), so node j's rows and
    backpointers equal node j-1's and no end candidate changes (strict
    <).  A bucket pads its graphs with such nodes up to its node bucket;
    copying their rows keeps both plain graph DPs' time to the real
    nodes (PERF.md)."""
    N = nopred.shape[1]
    same = [False] * N
    if N > 1:
        tab = torch.stack([x.to(torch.float64) for x in planes], dim=2)
        rep = (tab[:, 1:] == tab[:, :-1]).all(dim=2) & nopred[:, 1:] & nopred[:, :-1]
        same[1:] = rep.all(dim=0).cpu().tolist()
    return same


def poa_dp_dense(pos, mask, weight, preds, is_start, is_end, qmask, qlen,
                 n_real, col_weights, params: DpParams, max_insert=None,
                 subst=None, return_lattice: bool = False):
    """The dense graph DP over whole (N+1, M) lattices, batched: the
    cost set-up of poa_dp / poa_dp_forbid (or poa_dp_subst with
    `subst` (B, 4, 4)) and poa_dp_costs (align_kernel.py:409-545).
    pos/mask/weight (B, N), preds (B, N, P) int (-1 pad, P <= 8),
    is_start/is_end (B, N) bool, qmask (B, M), qlen/n_real (B,),
    col_weights (B, W) f32, max_insert (B, N) for forbid mode.
    Returns (bp (B, N, M) int16 slot-coded, best_j, best_i (B,) int64,
    raw (B,) f32); with `return_lattice` also the final V and D value
    planes (B, N, M) f32 (the --debug-lattice dump,
    align_kernel.py:423,543)."""
    dev = qmask.device
    f32, i64 = torch.float32, torch.int64
    B, N = pos.shape
    M = qmask.shape[1]
    P = preds.shape[2]
    if P > 8:
        raise ValueError(f"slot-coded backpointers hold at most 8 predecessors (P={P})")

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)

    big, one = c(BIG), c(1.0)
    match, mismatch = c(params.match), c(params.mismatch)
    costs = node_costs(pos, weight, col_weights, subst, params)
    subw, del_open, del_ext, ins_open, ins_ext = (
        costs[k] for k in ("subw", "dgo", "dge", "gio", "gie"))
    qm = qmask.long()
    nmask = mask.long()
    if subst is None:
        sq = pq = None
    else:
        bits_q = [((qm >> s) & 1).to(f32) for s in range(4)]
        pq = torch.zeros((B, M), dtype=f32, device=dev)
        for r in range(4):
            pq = pq + bits_q[r]
        sq = []
        for l in range(4):
            acc = torch.zeros((B, M), dtype=f32, device=dev)
            for r in range(4):
                acc = acc + subst[:, l, r : r + 1] * bits_q[r]
            sq.append(acc)

    lane = torch.arange(M, device=dev)[None, :]
    flane = lane.to(f32)
    ql = qlen.long()[:, None]
    iok = lane < ql
    valid = torch.arange(N, device=dev)[None, :] < n_real.long()[:, None]
    endv = is_end.bool() & valid
    start = is_start.bool()
    predl = preds.long()
    V = torch.full((B, N + 1, M), BIG, dtype=f32, device=dev)
    D = torch.full((B, N + 1, M), BIG, dtype=f32, device=dev)
    BP = torch.empty((B, N, M), dtype=torch.int16, device=dev)
    b1v = torch.full((B,), BIG, dtype=f32, device=dev)
    b1j = torch.zeros(B, dtype=i64, device=dev)
    b2v = torch.full((B,), BIG, dtype=f32, device=dev)
    b2j = torch.zeros(B, dtype=i64, device=dev)
    b2i = torch.zeros(B, dtype=i64, device=dev)
    bigcol = big.expand(B, P, 1)
    same = _repeats_previous(
        [subw, del_open, del_ext, ins_open, ins_ext, nmask, start, endv, valid]
        + ([max_insert] if max_insert is not None else []), (predl < 0).all(dim=2))

    for j in range(N):
        if same[j]:                     # a repeated padding node
            BP[:, j] = BP[:, j - 1]
            V[:, j + 1] = V[:, j]
            D[:, j + 1] = D[:, j]
            continue
        pj = predl[:, j] + 1                                  # 0 = virtual BIG row
        ok = (predl[:, j] >= 0)[:, :, None]                    # (B, P, 1)
        idx = pj[:, :, None].expand(B, P, M)
        Vp = torch.where(ok, V.gather(1, idx), big)            # (B, P, M)
        Dp = torch.where(ok, D.gather(1, idx), big)

        edge = start[:, j : j + 1] | (lane == 0)
        base = torch.where(edge, one, big)

        d_open = Vp + del_open[:, j, None, None]
        d_ext = Dp + del_ext[:, j, None, None]
        dcand = torch.minimum(d_open, d_ext)
        dslot = dcand.argmin(dim=1, keepdim=True)
        dmin = dcand.gather(1, dslot)[:, 0]
        # tie: the reference opens only on strict < (mesh.h:316-323)
        dsel_open = d_open.gather(1, dslot)[:, 0] < d_ext.gather(1, dslot)[:, 0]
        Drow = torch.minimum(base, dmin)

        Vp_prev = torch.cat([bigcol, Vp[:, :, :-1]], dim=2)
        mslot = Vp_prev.argmin(dim=1, keepdim=True)
        sub = _dense_sub(j, nmask, qm, subw, match, mismatch, sq, pq)
        Mc = Vp_prev.gather(1, mslot)[:, 0] + sub

        # U with reference tie priority: edge keeps ties vs D; M strict
        take_d = dmin < base
        U = torch.where(take_d, dmin, base)
        codeU = torch.where(take_d, CODE_DEL, CODE_EDGE)
        take_m = Mc < U
        U = torch.where(take_m, Mc, U)
        codeU = torch.where(take_m, CODE_MATCH, codeU)

        go_i = ins_open[:, j : j + 1]
        ge_i = ins_ext[:, j : j + 1]
        cand = _fma(-(flane + 1.0), ge_i, U + go_i)
        if max_insert is None:
            run = torch.cummin(cand, dim=1).values
            prefix = torch.minimum(_shift_right(run, 1, 1.0), one)
        else:
            # bounded runs, no edge seed (mesh.h:403-437)
            bud = max_insert[:, j : j + 1]
            wm = _windowed_min(cand, bud, M)
            prefix = _shift_right(wm, 1, BIG)
            prefix = torch.where(bud < 1, big, prefix)
        Irow = _fma(flane, ge_i, prefix)
        # opened at i (vs extended): U[i-1]+go <= I[i-1]+ge
        Iprev = _shift_right(Irow, 1, BIG)
        Uprev = _shift_right(U, 1, BIG)
        ins_opened = (Uprev + go_i) <= (Iprev + ge_i)

        take_i = Irow <= U                         # ties -> insertion
        Vrow = torch.where(take_i, Irow, U)
        code = torch.where(take_i, CODE_INS, codeU)
        BP[:, j] = (code | (mslot[:, 0] << 2) | (dslot[:, 0] << 5)
                    | (dsel_open.long() << 8) | (ins_opened.long() << 9)
                    ).to(torch.int16)
        V[:, j + 1] = Vrow
        D[:, j + 1] = Drow

        # end candidates (mesh.h:569-592), kept as running minima with
        # strict <: the earliest j, then the lowest lane, as the flat
        # argmins of poa_dp_costs
        v = torch.where(valid[:, j], Vrow.gather(1, ql - 1)[:, 0], big)
        upd = v < b1v
        b1v = torch.where(upd, v, b1v)
        b1j = torch.where(upd, j, b1j)
        row = torch.where(endv[:, j : j + 1] & iok, Vrow, big)
        ia = row.argmin(dim=1, keepdim=True)
        v = row.gather(1, ia)[:, 0]
        upd = v < b2v
        b2v = torch.where(upd, v, b2v)
        b2j = torch.where(upd, j, b2j)
        b2i = torch.where(upd, ia[:, 0], b2i)

    use2 = b2v < b1v                                   # strict (mesh.h:588)
    best_j = torch.where(use2, b2j, b1j)
    best_i = torch.where(use2, b2i, ql[:, 0] - 1)
    raw = torch.where(use2, b2v, b1v)
    if return_lattice:
        return BP, best_j, best_i, raw, V[:, 1:], D[:, 1:]
    return BP, best_j, best_i, raw


def traceback_dense(bp, best_j, best_i, preds, is_start):
    """The traceback state machine of traceback_device
    (align_kernel.py:626-714) over slot-coded backpointers, stepping all
    B queries at once.  Returns (emit (B, M) int32, done (B,) int32: 1
    where the walk reached DONE within N + 2M + 8 steps)."""
    dev = bp.device
    B, N, M = bp.shape
    P = preds.shape[2]
    predl = preds.long()
    start = is_start.bool()
    rows = torch.arange(B, device=dev)
    j = best_j.long().clone()
    i = best_i.long().clone()
    state = torch.full((B,), _S_RESOLVE, dtype=torch.long, device=dev)
    emit = torch.full((B, M + 1), -1, dtype=torch.int32, device=dev)  # col M: discard
    dump = torch.full((B,), M, dtype=torch.long, device=dev)
    for step in range(N + 2 * M + 8):
        if step % 64 == 0 and not bool((state != _S_DONE).any()):
            break
        cell = bp[rows, j, i].long()
        code = cell & 3
        mslot = (cell >> 2) & 7
        dslot = (cell >> 5) & 7
        dopen = ((cell >> 8) & 1) == 1
        iopen = ((cell >> 9) & 1) == 1
        at_edge = (i == 0) | start[rows, j]

        is_res = (state == _S_RESOLVE) | (state == _S_RESOLVE_NE)
        is_chain = (state == _S_CHAIN) | (state == _S_CHAIN_NE)
        is_dec = state == _S_DECIDE
        is_ins = state == _S_INS

        # resolve
        is_del = (code == CODE_DEL) & ~at_edge
        res_state = torch.where(
            is_del, torch.where(state == _S_RESOLVE, _S_CHAIN, _S_CHAIN_NE), _S_DECIDE)
        # chain
        pc = predl[rows, j, dslot.clamp(max=P - 1)]
        pc = torch.where(pc < 0, j, pc)
        stop = dopen | start[rows, pc]
        ch_state = torch.where(
            stop, torch.where(state == _S_CHAIN, _S_RESOLVE, _S_RESOLVE_NE), state)
        # decide
        done = at_edge | (code == CODE_EDGE)
        is_m = code == CODE_MATCH
        pm = predl[rows, j, mslot.clamp(max=P - 1)]
        pm = torch.where(pm < 0, j, pm)
        move = is_m & ~done
        dec_state = torch.where(
            done, _S_DONE,
            torch.where(is_m, _S_RESOLVE,
                        torch.where(code == CODE_INS, _S_INS, _S_CHAIN_NE)))
        # insertion run
        ni = i - 1
        idone = ni < 0
        safe = ni.clamp(min=0)
        ins_state = torch.where(idone, _S_DONE, torch.where(iopen, _S_DECIDE, _S_INS))

        at = torch.where(is_res & (state == _S_RESOLVE) & ~is_del, i,
                         torch.where(is_ins & ~idone, safe, dump))
        emit.scatter_(1, at[:, None], j.to(torch.int32)[:, None])

        nj = torch.where(is_chain, pc, torch.where(is_dec & move, pm, j))
        ni_ = torch.where(is_dec & move, i - 1, torch.where(is_ins, safe, i))
        state = torch.where(is_res, res_state,
                            torch.where(is_chain, ch_state,
                                        torch.where(is_dec, dec_state,
                                                    torch.where(is_ins, ins_state, state))))
        j, i = nj, ni_
    return emit[:, :M].contiguous(), (state == _S_DONE).to(torch.int32)


# predecessor slots a node record of csrc/graph_dense.cu holds (the
# slot-coded backpointers' 3-bit fields)
MAX_SLOTS = 8


def dense_node_table(pos, mask, weight, preds, is_start, is_end, n_real,
                     col_weights, params: DpParams, max_insert=None,
                     subst=None, *, M: int, chip_depth: int | None = None) -> torch.Tensor:
    """The dense kernel's (B, N, 16) int32 per-node table, one 64-byte
    record per node: subw, deletion open and extend, insertion open and
    extend (float32 bits, the plain version's own values from
    node_costs), mask | flags << 8, the insertion budget, its window's
    divisor, and the node's predecessor slots, -1 past P.

    flags: 1 start; 2 end (of real nodes only); 4 real node; 8 repeat:
    the node and the one before it have no predecessors and the same
    record up to this flag, so the node's rows are the previous node's
    (the rule of _repeats_previous, per query); 16 deep, only with
    `chip_depth`: a successor reads the node's row from more than
    chip_depth nodes back, beyond the kernel's on-chip rows, so the
    kernel also writes it to its global scratch.  The divisor (forbid
    mode, M the query width) is ceil(2**32 / R) for R = clip(budget, 1,
    M) >= 2, else 0, as int32 bits (csrc/forbid_window.cuh)."""
    i32 = torch.int32
    B, N = pos.shape
    P = preds.shape[2]
    dev = pos.device
    costs = node_costs(pos, weight, col_weights, subst, params)
    valid = torch.arange(N, device=dev)[None, :] < n_real[:, None]
    tab = torch.empty((B, N, 8 + MAX_SLOTS), dtype=i32, device=dev)
    for k, name in enumerate(("subw", "dgo", "dge", "gio", "gie")):
        tab[:, :, k] = costs[name].view(i32)
    tab[:, :, 5] = (mask.to(i32) | (is_start.to(i32) << 8) | ((is_end & valid).to(i32) << 9)
                    | (valid.to(i32) << 10))
    if max_insert is not None:
        tab[:, :, 6] = max_insert
        R = max_insert.long().clamp(1, M)
        rdiv = torch.where(R > 1, (0xFFFFFFFF + R) // R, 0)
        tab[:, :, 7] = torch.where(rdiv >= 2**31, rdiv - 2**32, rdiv)
    else:
        tab[:, :, 6:8] = 0
    tab[:, :, 8:8 + P] = preds
    tab[:, :, 8 + P:] = -1
    nopred = (preds < 0).all(dim=2)
    rep = (tab[:, 1:] == tab[:, :-1]).all(dim=2) & nopred[:, 1:] & nopred[:, :-1]
    tab[:, 1:, 5] |= rep.to(i32) << 11
    if chip_depth is not None:
        far = (preds >= 0) & (torch.arange(N, dtype=i32, device=dev)[None, :, None] - preds
                              > chip_depth)
        deep = torch.zeros((B, N + 1), dtype=i32, device=dev)  # column N: no node
        deep.scatter_(1, torch.where(far, preds, N).reshape(B, -1).long(), 1)
        tab[:, :, 5] |= deep[:, :N] << 12
    return tab


def graph_dp_dense(pos, mask, weight, preds, is_start, is_end, qmask, qlen,
                   n_real, col_weights, params: DpParams, max_insert=None,
                   subst=None, *, maxd: int):
    """The dense graph DP; see poa_dp_dense for the contract (pos int32,
    mask uint8, weight f32, preds int32, is_start/is_end bool, qmask
    uint8, qlen/n_real int32, col_weights f32, max_insert int32, subst
    f32).  CPU tensors take the plain version; CUDA tensors launch
    csrc/graph_dense.cu (or raise), which keeps the rows of the last
    maxd nodes (on chip, and those read from farther back than the
    chip holds also in a global scratch of maxd + 1 rows a query that
    the launch plan sizes): maxd must be at least the bucket's largest
    predecessor distance j - p (the dispatcher's).  A predecessor
    farther back fails a device-side assert in the kernel, which the
    next synchronising call raises as a RuntimeError (and which leaves
    the process's CUDA context unusable, as any CUDA kernel assert
    does)."""
    if qmask.device.type == "cpu":
        return poa_dp_dense(pos, mask, weight, preds, is_start, is_end, qmask,
                            qlen, n_real, col_weights, params, max_insert, subst)
    dev = qmask.device
    for name, t, dtype, ndim in (
        ("pos", pos, torch.int32, 2), ("mask", mask, torch.uint8, 2),
        ("weight", weight, torch.float32, 2), ("preds", preds, torch.int32, 3),
        ("is_start", is_start, torch.bool, 2), ("is_end", is_end, torch.bool, 2),
        ("qmask", qmask, torch.uint8, 2), ("qlen", qlen, torch.int32, 1),
        ("n_real", n_real, torch.int32, 1), ("col_weights", col_weights, torch.float32, 2),
    ):
        kernels.require_cuda(name, t, dtype, dev, ndim)
    if max_insert is not None:
        kernels.require_cuda("max_insert", max_insert, torch.int32, dev, 2)
    if subst is not None:
        kernels.require_cuda("subst", subst, torch.float32, dev, 3)
    B, N = pos.shape
    M = qmask.shape[1]
    P = preds.shape[2]
    for name, t in (("mask", mask), ("weight", weight), ("is_start", is_start),
                    ("is_end", is_end)) + ((("max_insert", max_insert),)
                                           if max_insert is not None else ()):
        if tuple(t.shape) != (B, N):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, N)}")
    if preds.shape[:2] != (B, N) or not 1 <= P <= MAX_SLOTS:
        raise ValueError(f"preds must be (B, N, P) with 1 <= P <= {MAX_SLOTS}, "
                         f"got {tuple(preds.shape)}")
    if (tuple(qmask.shape) != (B, M) or tuple(qlen.shape) != (B,)
            or tuple(n_real.shape) != (B,) or col_weights.shape[0] != B):
        raise ValueError("qmask must be (B, M), qlen and n_real (B,), col_weights (B, W)")
    if subst is not None and tuple(subst.shape) != (B, 4, 4):
        raise ValueError("subst must be (B, 4, 4)")
    maxd = int(maxd)
    if not 0 <= maxd <= N:
        raise ValueError(f"the ring of maxd + 1 = {maxd + 1} node rows must hold 1 to "
                         f"N + 1 = {N + 1}")
    if not 0 < M <= 16384:
        raise ValueError(f"graph_dp_dense kernel needs 1 <= M <= 16384 (M={M})")
    aspace = max_insert is not None
    cfg = graph_dp_dense_plan(M, aspace, maxd, dev)
    rows = cfg["scratch_rows"]
    table = dense_node_table(pos, mask, weight, preds, is_start, is_end, n_real,
                             col_weights, params, max_insert, subst, M=M,
                             chip_depth=max(cfg["shared_rows"], 1) if rows else None)
    smat = (subst.reshape(B, 16).contiguous() if subst is not None
            else torch.zeros((B, 16), dtype=torch.float32, device=dev))
    bp = torch.empty((B, N, M), dtype=torch.int16, device=dev)
    best = torch.empty((B, 8), dtype=torch.float32, device=dev)
    scratch = (torch.empty((B, rows * cfg["ring_row"]), dtype=torch.float32, device=dev)
               if rows else None)
    kernels.launch(
        "graph_dp_dense", kernels.lib().sina_graph_dp_dense,
        table.data_ptr(), qmask.data_ptr(), qlen.data_ptr(), smat.data_ptr(),
        bp.data_ptr(), best.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, N, M, maxd, int(aspace), int(subst is not None), params.match,
        params.mismatch, device=dev,
    )
    # (v1, j1, v2, j2, i2): the two end candidates, decoded as
    # poa_dp_dense decodes its running minima
    v1, j1, v2, j2, i2 = (best[:, k] for k in range(5))
    use2 = v2 < v1                                     # strict (mesh.h:588)
    best_j = torch.where(use2, j2, j1).long()
    best_i = torch.where(use2, i2.long(), qlen.long() - 1)
    return bp, best_j, best_i, torch.where(use2, v2, v1)


def graph_dp_dense_plan(M: int, aspace: bool, maxd: int,
                        device: torch.device | None = None) -> dict:
    """The dense DP kernel's launch plan on `device` (needs the card)
    for M query positions and the largest predecessor distance maxd:
    lanes a thread, threads, floats of a node row, dynamic and static
    shared memory bytes a block, registers a thread, the rows of the
    shared-memory ring (the distances up to max(shared_rows, 1) are on
    chip) and the rows of the global scratch a query (maxd + 1 where
    maxd is beyond the chip's rows, else 0)."""
    out = kernels.plan(kernels.lib().sina_graph_dp_dense_plan, M, int(aspace), int(maxd),
                       n=8, device=device)
    keys = ("lanes", "threads", "ring_row", "dyn_smem", "static_smem", "regs",
            "shared_rows", "scratch_rows")
    return dict(zip(keys, out))


def graph_traceback_dense(bp, best_j, best_i, preds, is_start):
    """emit (B, M) int32, the node that consumed each query base (-1 =
    none), and done (B,) int32; see traceback_dense.  CPU tensors take
    the plain version; CUDA tensors (bp int16, preds int32, is_start
    bool) launch csrc/graph_dense.cu's walk (or raise)."""
    if bp.device.type == "cpu":
        return traceback_dense(bp, best_j, best_i, preds, is_start)
    dev = bp.device
    kernels.require_cuda("bp", bp, torch.int16, dev, 3)
    kernels.require_cuda("preds", preds, torch.int32, dev, 3)
    kernels.require_cuda("is_start", is_start, torch.bool, dev, 2)
    B, N, M = bp.shape
    P = preds.shape[2]
    if (preds.shape[:2] != (B, N) or tuple(is_start.shape) != (B, N)
            or not 1 <= P <= MAX_SLOTS):
        raise ValueError(f"preds must be (B, N, P) with 1 <= P <= {MAX_SLOTS} and is_start "
                         "(B, N) for bp (B, N, M)")
    for name, t in (("best_j", best_j), ("best_i", best_i)):
        if t.device != dev or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be ({B},) on {dev}")
    bj = best_j.to(torch.int32).contiguous()
    bi = best_i.to(torch.int32).contiguous()
    emit = torch.empty((B, M), dtype=torch.int32, device=dev)
    done = torch.empty(B, dtype=torch.int32, device=dev)
    kernels.launch(
        "graph_traceback_dense", kernels.lib().sina_graph_traceback_dense,
        bp.data_ptr(), bj.data_ptr(), bi.data_ptr(), preds.data_ptr(),
        is_start.data_ptr(), emit.data_ptr(), done.data_ptr(), B, N, M, P,
        device=dev,
    )
    return emit, done


def graph_traceback_dense_plan(bp: torch.Tensor) -> dict:
    """The dense traceback kernel's launch plan for the plane bp (needs
    the card): threads (one of them walks), the staged window's nodes
    and query positions, bytes a window copy moves at once (16 where
    bp's nodes are 16-byte aligned, else 4 or 2), dynamic and static
    shared memory bytes a block, registers a thread."""
    out = kernels.plan(kernels.lib().sina_graph_traceback_dense_plan, bp.data_ptr(),
                       bp.shape[-1], n=7, device=bp.device)
    keys = ("threads", "window_nodes", "window_rows", "copy_bytes", "dyn_smem",
            "static_smem", "regs")
    return dict(zip(keys, out))


def emit_to_pairs(emit: np.ndarray) -> tuple[list, int]:
    """Convert a device emission row to ([(node, slave_i)], head)
    (sina_tpu/ops/align_kernel.py:608-613)."""
    idx = np.nonzero(emit >= 0)[0]
    pairs = [(int(emit[i]), int(i)) for i in idx]
    head = int(idx[0]) if len(idx) else 0
    return pairs, head


def traceback(
    bp: np.ndarray,
    best_j: int,
    best_i: int,
    node_pos: np.ndarray,
    preds: np.ndarray,
    is_start: np.ndarray,
) -> tuple[list[tuple[int, int]], int]:
    """Walk one query's packed backpointers on the host
    (sina_tpu/ops/align_kernel.py:717-795); returns ([(node_or_-1,
    slave_i)] in left-to-right slave order, head).  node -1 marks
    left-overhang bases (the walk ended before slave position 0).
    Inserted bases report the anchor node (they share its column; the
    NAST shift later spreads them, mesh.h:642-685 semantics)."""
    def resolve(j: int, i: int) -> int:
        """Follow deletion-valued cells back to the node where slave
        base i is actually consumed (the reference's skip-cell logic,
        mesh.h:648-655, generalised to chained deletions)."""
        while not (is_start[j] or i == 0):
            if int(bp[j, i]) & 0x3 != CODE_DEL:
                break
            # follow this cell's deletion chain to its opening
            while True:
                cell = int(bp[j, i])
                slot = (cell >> 5) & 0x7
                opened = (cell >> 8) & 1
                j = int(preds[j, slot])
                if opened or is_start[j]:
                    break
        return j

    out = []  # (slave_i, node_j) emitted right-to-left
    j, i = int(best_j), int(best_i)
    j = resolve(j, i)
    out.append((i, j))
    while not (i == 0 or is_start[j]):
        cell = int(bp[j, i])
        c = cell & 0x3
        if c == CODE_EDGE:
            break  # free start: remaining bases are left overhang
        if c == CODE_DEL:
            # reached e.g. after an insertion run whose anchor's value
            # came from the deletion track: hop back, no emission (the
            # anchor was already emitted at the insertion node, as in
            # the reference, mesh.h:664-684)
            j = resolve(j, i)
            continue
        if c == CODE_MATCH:
            slot = (cell >> 2) & 0x7
            j = int(preds[j, slot])
            i -= 1
            j = resolve(j, i)
            out.append((i, j))
        else:  # CODE_INS: run of inserted bases anchored at node j
            while True:
                opened = (int(bp[j, i]) >> 9) & 1
                i -= 1
                if i < 0:
                    break
                out.append((i, j))
                if opened:
                    break
            if i < 0:
                break
            # anchor consumed at j; continue main loop from (j, i)
    head = out[-1][0]  # leftmost emitted slave index
    return [(j, i) for (i, j) in reversed(out)], head
