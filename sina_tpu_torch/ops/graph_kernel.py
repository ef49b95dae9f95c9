"""The POA graph DP (the mseq engine) and its distance-coded traceback.

``graph_dp`` launches csrc/graph_dp.cu (the port of
sina_tpu/ops/graph_pallas.py _graph_kernel / graph_dp_pallas_packed)
for CUDA tensors and runs the plain version ``graph_dp_plain`` for CPU
tensors.  ``graph_traceback`` launches csrc/graph_traceback.cu (the
port of graph_pallas.traceback_device_dist) or runs
``graph_traceback_plain``.

Semantics are the Pallas kernel's, with one difference in what the
backpointer plane records (never in the DP values, the end cell, the
raw score or the traceback): the predecessor probe visits only the
distances set in a node's ``predbits``, in ascending order with
``<=``, so ties keep the largest distance (the lowest predecessor id)
as graph_pallas.py:196-221 does.  The Pallas kernel probed every ring
row and let a non-predecessor's BIG win ties in cells whose value is
BIG; there it recorded distance K-1, here it records the largest real
predecessor distance (or 0).  Such cells never lie on a traceback.

Layouts: per-node planes (B, N) (node j of query b at [b, j]); qmask
(B, M) uint8 IUPAC masks; bp (B, N, M) int16 holding the reference's
uint16 bit layout (bits 0-1 code, 2-6 match distance, 7-11 deletion
distance, 12 deletion opened, 13 insertion opened); emit (B, M) int32
(the node that consumed each query base, -1 = none).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import timing
from . import kernels
from .align_kernel import (
    _S_CHAIN, _S_CHAIN_NE, _S_DECIDE, _S_DONE, _S_INS, _S_RESOLVE,
    _S_RESOLVE_NE, BIG, CODE_DEL, CODE_EDGE, CODE_INS, CODE_MATCH, DpParams,
    _repeats_previous, _windowed_min, node_costs,
)

# the kernel's 5-bit distance fields: a bucket with a predecessor at
# distance >= 32 (a family member with an indel of about 32 columns
# makes one) takes the dense route (align_kernel.graph_dp_dense)
MAX_DIST = 32


def _pack_graph_numpy(mask, preds, is_start, is_end, n_real):
    """numpy version of native.pack_graph (sina_tpu/ops/graph_pallas.py:453-467)."""
    N = mask.shape[1]
    nodeid = np.arange(N, dtype=np.int64)[None, :, None]
    dist = nodeid - preds                                   # (B, N, P)
    okp = (preds >= 0) & (dist > 0) & (dist < MAX_DIST)
    bits = np.where(
        okp, np.left_shift(np.uint32(1), dist.astype(np.uint32),
                           dtype=np.uint32), np.uint32(0)
    )
    predbits = np.bitwise_or.reduce(bits, axis=2).view(np.int32)
    flags = (
        is_start.astype(np.uint8)
        | (is_end.astype(np.uint8) << 1)
        | ((np.arange(N)[None, :] < n_real[:, None]).astype(
            np.uint8) << 2)
    )
    return predbits, flags


def pack_graph_host(mask, preds, is_start, is_end, n_real):
    """Host compression of the graph planes the kernel reads
    (sina_tpu/ops/graph_pallas.py:429-467): the (B, N, P) predecessor
    lists become a per-node distance bitmask (B, N) int32 (bit d set
    iff a predecessor sits d topological positions back, d < 32), and
    start/end/real fold into one (B, N) uint8 flag plane (bit 0 start,
    bit 1 end, bit 2 real node).  Uses the native packer, or numpy
    when it is unavailable.  Returns (mask uint8, predbits, flags)."""
    from .. import native

    mask = np.asarray(mask)
    preds = np.asarray(preds)
    is_start = np.asarray(is_start)
    is_end = np.asarray(is_end)
    n_real = np.asarray(n_real)
    nat = native.pack_graph(
        preds.astype(np.int32, copy=False),
        is_start.astype(np.uint8, copy=False),
        is_end.astype(np.uint8, copy=False),
        n_real.astype(np.int64, copy=False),
    )
    if nat is None:
        nat = _pack_graph_numpy(mask, preds, is_start, is_end, n_real)
    predbits, flags = nat
    return mask.astype(np.uint8), predbits, flags


def pick_k_ring(maxd: int) -> int:
    """The ring depth of a bucket whose largest predecessor distance is
    maxd: 0 when a distance does not fit the kernel's 5-bit fields (the
    reference's routing threshold, graph_pallas.py:671-677), else
    maxd + 1 (at least 2).  Any depth above maxd gives the same result;
    the smallest one keeps the kernel's ring in shared memory at the
    widest buckets."""
    if maxd >= MAX_DIST:
        return 0
    return max(2, int(maxd) + 1)


def _decode_best(best: torch.Tensor, qlen: torch.Tensor):
    """(B, 8) f32 summary (v1, j1, v2, j2, i2) -> best_j, best_i (B,)
    int32 and raw (B,) f32 (graph_pallas.py:629-639)."""
    v1, j1, v2, j2, i2 = (best[:, k] for k in range(5))
    zero = torch.zeros_like(j1)
    # empty candidate sets leave BIG sentinels in j/i; clamp like the
    # XLA argmin-of-all-BIG (index 0)
    j1 = torch.where(v1 >= BIG, zero, j1)
    j2 = torch.where(v2 >= BIG, zero, j2)
    i2 = torch.where(v2 >= BIG, zero, i2)
    use2 = v2 < v1                                  # strict (mesh.h:588)
    best_j = torch.where(use2, j2, j1).to(torch.int32)
    best_i = torch.where(use2, i2.to(torch.int32), qlen.to(torch.int32) - 1)
    raw = torch.where(use2, v2, v1)
    return best_j, best_i, raw


def _sfac_table(qmask, smat, params: DpParams) -> torch.Tensor:
    """The substitution cost's factor for each of the 16 IUPAC node
    masks, (16, B, M) float64 (exact f32 values): the scheme's match or
    mismatch value, or with the matrix scheme the mean of subst[l, r]
    over the letter pairs (graph_pallas.py:131-146, 177-188), in the
    reference's f32 operations.  Mc multiplies it by subw."""
    dev = qmask.device
    f32 = torch.float32
    qm = qmask.to(torch.int32)
    if smat is None:
        v = torch.arange(16, dtype=torch.int32, device=dev)[:, None, None]
        return torch.where((v & qm[None]) != 0,
                           torch.tensor(params.match, dtype=f32, device=dev),
                           torch.tensor(params.mismatch, dtype=f32, device=dev)).double()
    B, M = qm.shape
    qbits = [((qm >> r) & 1).to(f32) for r in range(4)]
    pq = torch.zeros((B, M), dtype=f32, device=dev)
    for r in range(4):
        pq = pq + qbits[r]
    sq = []
    for l in range(4):
        acc = torch.zeros((B, M), dtype=f32, device=dev)
        for r in range(4):
            acc = acc + smat[:, 4 * l + r : 4 * l + r + 1] * qbits[r]
        sq.append(acc)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    tabs = []
    for v in range(16):
        numer = torch.zeros((B, M), dtype=f32, device=dev)
        pn = torch.zeros((), dtype=f32, device=dev)
        for l in range(4):
            bit = torch.tensor(float((v >> l) & 1), dtype=f32, device=dev)
            numer = numer + bit * sq[l]
            pn = pn + bit
        tabs.append(numer / torch.maximum(pn * pq, one))
    return torch.stack(tabs).double()


def _graph_core_plain(costs, mask, predbits, flags, budget, qmask, qlen, smat,
                      params: DpParams, k_ring: int):
    """The DP of _graph_kernel as a loop over the N nodes on (B, M)
    tensors.  Where the reference selects with a strict or non-strict
    comparison between two values, the selected value is their minimum
    either way, so values are taken with torch.minimum and only the
    backpointer bits follow the comparisons.  Returns (bp (B, N, M)
    int16, best (B, 8) f32)."""
    dev = qmask.device
    f32, i32 = torch.float32, torch.int32
    B, N = mask.shape
    M = qmask.shape[1]
    K = k_ring
    inf = float("inf")

    rows = torch.arange(B, device=dev)
    lane = torch.arange(M, device=dev)
    flane = lane.to(f32)
    fl_d = flane.double()[None]                      # Irow's multiplier
    negfl1_d = (-(flane + 1.0)).double()[None]       # the insertion candidate's
    ql1 = qlen.long() - 1
    vlm = lane[None] < qlen.long()[:, None]
    aspace = budget is not None
    sfac16 = _sfac_table(qmask, smat, params)

    # per-node planes as (N, B, 1) views
    def nodes(x):
        return x.t().contiguous()[:, :, None]

    subw_d = nodes(costs["subw"].double())
    dgo, dge = nodes(costs["dgo"]), nodes(costs["dge"])
    gio, gie = nodes(costs["gio"]), nodes(costs["gie"])
    gie_d = gie.double()
    nm4 = nodes((mask.to(i32) & 0xF).long())[:, :, 0]          # (N, B)
    pb = nodes(predbits.to(torch.int64) & 0xFFFFFFFF)
    fl = nodes(flags.to(i32))
    start = (fl & 1) != 0
    valid = (fl & 4) != 0
    endv = (fl & 6) == 6
    bud = nodes(budget.to(i32)) if aspace else None

    # probes[j]: the distances d set in node j's predbits for any query
    # of the batch, ascending, each with the (B, 1) mask of the queries
    # that lack it (None where every query has it)
    dbits = torch.arange(MAX_DIST, device=dev)
    has = (((pb[:, :, 0, None] >> dbits) & 1) != 0)            # (N, B, 32)
    any_d = has.any(dim=1).cpu().numpy()
    all_d = has.all(dim=1).cpu().numpy()
    probes = [[(int(d), None if all_d[j, d] else ~has[j, :, d, None])
               for d in np.flatnonzero(any_d[j])] for j in range(N)]
    same = _repeats_previous(
        [costs[k] for k in ("subw", "dgo", "dge", "gio", "gie")]
        + [mask.to(i32) & 0xF, flags.to(i32)] + ([budget] if aspace else []),
        predbits == 0)
    has_end = endv.any(dim=1)[:, 0].cpu().tolist()
    any_valid = valid.any(dim=1)[:, 0].cpu().tolist()
    bmax = bud.amax(dim=1)[:, 0].cpu().tolist() if aspace else None

    bigrow = torch.full((B, M), BIG, dtype=f32, device=dev)
    base0 = torch.full((1, M), BIG, dtype=f32, device=dev)
    base0[0, 0] = 1.0
    one = torch.tensor(1.0, dtype=f32, device=dev)
    vring = [bigrow] * K
    dring = [bigrow] * K
    c1v = torch.full((B,), BIG, dtype=f32, device=dev)
    c1j = torch.zeros((B,), dtype=f32, device=dev)
    c2v = bigrow.clone()
    c2j = torch.zeros((B, M), dtype=f32, device=dev)
    bp = torch.empty((B, N, M), dtype=torch.int16, device=dev)

    for j in range(N):
        if same[j]:                     # a repeated padding node
            bp[:, j] = bp[:, j - 1]
            vring[j % K] = vring[(j - 1) % K]
            dring[j % K] = dring[(j - 1) % K]
            continue
        # predecessor probe over the distances set in predbits,
        # ascending with <=: ties keep the largest distance (the lowest
        # predecessor id), as graph_pallas.py:196-221
        vmin = dmin = bigrow
        mdist4 = torch.zeros((B, M), dtype=i32, device=dev)      # 4 * distance
        ddist128 = torch.zeros((B, M), dtype=i32, device=dev)    # 128 * distance
        dopen = torch.zeros((B, M), dtype=torch.bool, device=dev)
        for d, notok in probes[j]:
            Vp = vring[(j - d) % K]
            vc = Vp if notok is None else Vp.masked_fill(notok, inf)
            mdist4.masked_fill_(vc <= vmin, 4 * d)
            vmin = torch.minimum(vmin, vc)
            do_ = Vp + dgo[j]
            de_ = dring[(j - d) % K] + dge[j]
            dc = torch.minimum(do_, de_)
            if notok is not None:
                dc.masked_fill_(notok, inf)
            upd = dc <= dmin
            ddist128.masked_fill_(upd, 128 * d)
            dopen = torch.where(upd, do_ < de_, dopen)
            dmin = torch.minimum(dmin, dc)

        # edge cells (start node or lane 0) start from 1.0
        base = torch.where(start[j], one, base0)
        Drow = torch.minimum(base, dmin)
        Mc = torch.addcmul(F.pad(vmin[:, :-1], (1, 0), value=BIG).double(),
                           sfac16[nm4[j], rows], subw_d[j]).float()
        code = (dmin < base).to(i32) * CODE_DEL
        U = Drow
        code.masked_fill_(Mc < U, CODE_MATCH)
        U = torch.minimum(U, Mc)

        # insertion track: closed-form prefix-min
        cand = torch.addcmul((U + gio[j]).double(), negfl1_d, gie_d[j]).float()
        if aspace:
            # bounded runs, no edge seed (--insertion=forbid,
            # mesh.h:403-437)
            if bmax[j] >= 1:
                wm = _windowed_min(cand, bud[j], M)
                prefix = F.pad(wm[:, :-1], (1, 0), value=BIG).masked_fill_(bud[j] < 1, BIG)
            else:
                prefix = bigrow
        else:
            x = torch.cummin(cand, dim=1).values
            prefix = F.pad(x[:, :-1], (1, 0), value=BIG).clamp_(max=1.0)
        Irow = torch.addcmul(prefix.double(), fl_d, gie_d[j]).float()
        ins_opened = ((F.pad(U[:, :-1], (1, 0), value=BIG) + gio[j])
                      <= (F.pad(Irow[:, :-1], (1, 0), value=BIG) + gie[j]))
        code.masked_fill_(Irow <= U, CODE_INS)             # ties -> insertion
        Vrow = torch.minimum(Irow, U)
        code += F.pad(mdist4[:, :-1], (1, 0))
        code += ddist128
        code += dopen.to(i32) << 12
        code += ins_opened.to(i32) << 13
        bp[:, j] = code
        vring[j % K] = Vrow
        dring[j % K] = Drow

        # running best-cell candidates (strict < keeps the earliest j);
        # candidate 1 lives at lane qlen-1 only
        if any_valid[j]:
            c1cand = torch.where(valid[j, :, 0], Vrow[rows, ql1], BIG)
            upd1 = c1cand < c1v
            c1v = torch.minimum(c1v, c1cand)
            c1j.masked_fill_(upd1, float(j))
        if has_end[j]:
            c2cand = torch.where(endv[j] & vlm, Vrow, BIG)
            c2j.masked_fill_(c2cand < c2v, float(j))
            c2v = torch.minimum(c2v, c2cand)

    # reduce to (B,) summaries; c2 ties resolve to the lowest j, then
    # the lowest lane (graph_pallas.py:298-330)
    v1, j1 = c1v[:, None], c1j[:, None]
    v2 = c2v.amin(dim=1, keepdim=True)
    at2 = c2v == v2
    j2 = torch.where(at2, c2j, BIG).amin(dim=1, keepdim=True)
    i2 = torch.where(at2 & (c2j == j2), flane, BIG).amin(dim=1, keepdim=True)
    best = torch.zeros((B, 8), dtype=f32, device=dev)
    best[:, :5] = torch.cat([v1, j1, v2, j2, i2], dim=1)
    return bp, best


def _check_operands(pos, mask, weight, predbits, flags, qmask, qlen,
                    col_weights, max_insert, subst):
    B, N = pos.shape
    M = qmask.shape[1]
    for name, t in (("mask", mask), ("weight", weight),
                    ("predbits", predbits), ("flags", flags)):
        if tuple(t.shape) != (B, N):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, N)}")
    if max_insert is not None and tuple(max_insert.shape) != (B, N):
        raise ValueError(f"max_insert has shape {tuple(max_insert.shape)}")
    if tuple(qmask.shape) != (B, M) or tuple(qlen.shape) != (B,):
        raise ValueError("qmask must be (B, M) and qlen (B,)")
    if col_weights.dim() != 2 or col_weights.shape[0] != B:
        raise ValueError("col_weights must be (B, W)")
    if subst is not None and tuple(subst.shape) != (B, 4, 4):
        raise ValueError("subst must be (B, 4, 4)")


def graph_dp_plain(pos, mask, weight, predbits, flags, qmask, qlen,
                   col_weights, max_insert=None, subst=None, *,
                   params: DpParams, k_ring: int):
    """Plain PyTorch version of the graph DP, on the operands' device.

    pos (B, N) int32 node columns, mask (B, N) uint8 IUPAC masks,
    weight (B, N) f32 node weights, predbits (B, N) int32 and flags
    (B, N) uint8 from pack_graph_host, qmask (B, M) uint8, qlen (B,)
    int32, col_weights (B, W) f32; max_insert (B, N) int32 selects the
    bounded insertion track (--insertion forbid), subst (B, 4, 4) f32
    the substitution-matrix scheme; both may be given.  k_ring must
    exceed the largest predecessor distance (pick_k_ring).  Returns (bp (B, N, M)
    int16, best_j (B,) int32, best_i (B,) int32, raw (B,) f32)."""
    _check_operands(pos, mask, weight, predbits, flags, qmask, qlen,
                    col_weights, max_insert, subst)
    costs = node_costs(pos, weight, col_weights, subst, params)
    smat = subst.reshape(subst.shape[0], 16) if subst is not None else None
    bp, best = _graph_core_plain(costs, mask, predbits, flags, max_insert,
                                 qmask, qlen, smat, params, k_ring)
    return (bp, *_decode_best(best, qlen))


def node_table(costs, mask, predbits, flags, max_insert) -> torch.Tensor:
    """The kernel's (B, N, 8) int32 per-node table, one 32-byte record
    per node: subw, dgo, dge, gio, gie (float32 bits), predbits,
    mask | flags << 8, and the insertion budget."""
    i32 = torch.int32
    mf = mask.to(i32) | (flags.to(i32) << 8)
    budget = max_insert.to(i32) if max_insert is not None else torch.zeros_like(mf)
    cols = [costs[k].contiguous().view(i32) for k in ("subw", "dgo", "dge", "gio", "gie")]
    return torch.stack(cols + [predbits.to(i32), mf, budget], dim=2).contiguous()


def graph_dp(pos, mask, weight, predbits, flags, qmask, qlen, col_weights,
             max_insert=None, subst=None, *, params: DpParams, k_ring: int):
    """The graph DP; see graph_dp_plain for the contract.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise):
    its ring of k_ring node rows in shared memory where it fits, else
    in a global scratch (counted in kernels.launches
    "graph_dp_global_ring"), chosen by shape before the launch."""
    if qmask.device.type == "cpu":
        return graph_dp_plain(pos, mask, weight, predbits, flags, qmask, qlen,
                              col_weights, max_insert, subst,
                              params=params, k_ring=k_ring)
    dev = qmask.device
    kernels.require_cuda("pos", pos, torch.int32, dev, 2)
    kernels.require_cuda("mask", mask, torch.uint8, dev, 2)
    kernels.require_cuda("weight", weight, torch.float32, dev, 2)
    kernels.require_cuda("predbits", predbits, torch.int32, dev, 2)
    kernels.require_cuda("flags", flags, torch.uint8, dev, 2)
    kernels.require_cuda("qmask", qmask, torch.uint8, dev, 2)
    kernels.require_cuda("qlen", qlen, torch.int32, dev, 1)
    kernels.require_cuda("col_weights", col_weights, torch.float32, dev, 2)
    if max_insert is not None:
        kernels.require_cuda("max_insert", max_insert, torch.int32, dev, 2)
    if subst is not None:
        kernels.require_cuda("subst", subst, torch.float32, dev, 3)
    _check_operands(pos, mask, weight, predbits, flags, qmask, qlen,
                    col_weights, max_insert, subst)
    B, N = pos.shape
    M = qmask.shape[1]
    if not 2 <= k_ring <= MAX_DIST:
        raise ValueError(f"k_ring must be in [2, 32] (got {k_ring})")
    if not 0 < M <= 16384:
        raise ValueError(f"graph_dp kernel needs 1 <= M <= 16384 (M={M})")
    aspace = max_insert is not None
    cfg = graph_dp_plan(M, k_ring, aspace, dev)
    costs = node_costs(pos, weight, col_weights, subst, params)
    table = node_table(costs, mask, predbits, flags, max_insert)
    smat = (subst.reshape(B, 16).contiguous() if subst is not None
            else torch.zeros((B, 16), dtype=torch.float32, device=dev))
    bp = torch.empty((B, N, M), dtype=torch.int16, device=dev)
    best = torch.empty((B, 8), dtype=torch.float32, device=dev)
    # the global-ring route's per-query scratch: the last K V and D rows
    # plus each thread's copy of V at the lane left of its own
    ring = (None if cfg["shared_ring"] else
            torch.empty((B, cfg["scratch"]), dtype=torch.float32, device=dev))
    kernels.launch(
        "graph_dp", kernels.lib().sina_graph_dp,
        table.data_ptr(), qmask.data_ptr(), qlen.data_ptr(), smat.data_ptr(),
        bp.data_ptr(), best.data_ptr(), None if ring is None else ring.data_ptr(),
        B, N, M, k_ring, int(aspace), int(subst is not None),
        params.match, params.mismatch, device=dev,
    )
    if ring is not None:
        kernels.launches["graph_dp_global_ring"] += 1
        timing.count("graph_dp.global_ring")
    return (bp, *_decode_best(best, qlen))


def graph_dp_plan(M: int, k_ring: int, aspace: bool,
                  device: torch.device | None = None) -> dict:
    """The graph DP kernel's launch plan on `device` (needs the card;
    by default the current device): lanes a
    thread, threads, whether the ring of k_ring node rows lives in
    shared memory (else the global-ring route), dynamic and static
    shared memory bytes a block, registers a thread, floats of global
    ring scratch a query, and the deepest ring shared memory holds.
    Queried once a shape and device (graph_dp needs it every launch)."""
    return dict(_graph_dp_plan(M, k_ring, bool(aspace), kernels.device_index(device)))


@functools.lru_cache(maxsize=1024)
def _graph_dp_plan(M: int, k_ring: int, aspace: bool, index: int) -> tuple:
    out = kernels.plan(kernels.lib().sina_graph_dp_plan, M, k_ring, int(aspace), n=8,
                       device=torch.device("cuda", index))
    keys = ("lanes", "threads", "shared_ring", "dyn_smem", "static_smem",
            "regs", "scratch", "max_shared_ring")
    return tuple(zip(keys, out))


def _walk(bp_b: np.ndarray, start_b: np.ndarray, j: int, i: int,
          emit_b: np.ndarray) -> tuple[bool, int]:
    """One query's traceback (graph_pallas.py:338-414) over its (N, M)
    plane: emit[i] = j for each consumed query base i.  Reads clamp
    (j, i) into the plane, as a JAX gather does.  Returns whether the
    walk reached DONE within N + 2M + 8 steps, and the steps it took."""
    N, M = bp_b.shape
    state = _S_RESOLVE
    steps = N + 2 * M + 8
    for step in range(steps):
        if state == _S_DONE:
            return True, step
        jj = min(max(j, 0), N - 1)
        cell = int(bp_b[jj, min(max(i, 0), M - 1)])
        code = cell & 3
        at_edge = i == 0 or bool(start_b[jj])
        if state in (_S_RESOLVE, _S_RESOLVE_NE):
            is_del = code == CODE_DEL and not at_edge
            if state == _S_RESOLVE and not is_del and 0 <= i < M:
                emit_b[i] = j
            if is_del:
                state = _S_CHAIN if state == _S_RESOLVE else _S_CHAIN_NE
            else:
                state = _S_DECIDE
        elif state in (_S_CHAIN, _S_CHAIN_NE):
            ddist = (cell >> 7) & 0x1F
            pj = max(j - ddist if ddist > 0 else j, 0)
            if (cell >> 12) & 1 or start_b[min(pj, N - 1)]:
                state = _S_RESOLVE if state == _S_CHAIN else _S_RESOLVE_NE
            j = pj
        elif state == _S_DECIDE:
            done = at_edge or code == CODE_EDGE
            if done:
                state = _S_DONE
            elif code == CODE_MATCH:
                mdist = (cell >> 2) & 0x1F
                j = max(j - mdist if mdist > 0 else j, 0)
                i -= 1
                state = _S_RESOLVE
            else:
                state = _S_INS if code == CODE_INS else _S_CHAIN_NE
        else:  # _S_INS
            ni = i - 1
            if ni < 0:
                state = _S_DONE
            else:
                i = ni
                if i < M:
                    emit_b[i] = j
                state = _S_DECIDE if (cell >> 13) & 1 else _S_INS
    return state == _S_DONE, steps


def graph_traceback_plain(bp, best_j, best_i, flags, steps=None):
    """Plain version: the per-query walk on host copies of the plane.
    bp (B, N, M) int16, best_j/best_i (B,) int32, flags (B, N) uint8 ->
    (emit (B, M) int32, done (B,) int32: 1 where the walk ended) on
    bp's device.  A (B,) numpy array `steps` receives each walk's step
    count."""
    B, N, M = bp.shape
    bpn = bp.cpu().numpy()
    start = (flags.cpu().numpy() & 1) != 0
    bj = best_j.cpu().numpy()
    bi = best_i.cpu().numpy()
    emit = np.full((B, M), -1, dtype=np.int32)
    done = np.zeros(B, dtype=np.int32)
    for b in range(B):
        done[b], n = _walk(bpn[b], start[b], int(bj[b]), int(bi[b]), emit[b])
        if steps is not None:
            steps[b] = n
    return (torch.from_numpy(emit).to(bp.device),
            torch.from_numpy(done).to(bp.device))


def graph_traceback(bp, best_j, best_i, flags):
    """emit (B, M) int32, the graph node that consumed each query base,
    and done (B,) int32; see graph_traceback_plain.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if bp.device.type == "cpu":
        return graph_traceback_plain(bp, best_j, best_i, flags)
    dev = bp.device
    kernels.require_cuda("bp", bp, torch.int16, dev, 3)
    kernels.require_cuda("best_j", best_j, torch.int32, dev, 1)
    kernels.require_cuda("best_i", best_i, torch.int32, dev, 1)
    kernels.require_cuda("flags", flags, torch.uint8, dev, 2)
    B, N, M = bp.shape
    if tuple(flags.shape) != (B, N):
        raise ValueError(f"flags has shape {tuple(flags.shape)}, expected {(B, N)}")
    emit = torch.empty((B, M), dtype=torch.int32, device=dev)
    done = torch.empty(B, dtype=torch.int32, device=dev)
    kernels.launch(
        "graph_traceback", kernels.lib().sina_graph_traceback,
        bp.data_ptr(), best_j.data_ptr(), best_i.data_ptr(), flags.data_ptr(),
        emit.data_ptr(), done.data_ptr(), B, N, M, device=dev,
    )
    return emit, done


def graph_traceback_plan(bp: torch.Tensor) -> dict:
    """The graph traceback kernel's launch plan for the plane bp (needs
    the card): threads, the staged window's nodes and query positions,
    bytes a window copy moves at once (16 where bp's nodes are 16-byte
    aligned, else 4 or 2), dynamic and static shared memory bytes a
    block, registers a thread."""
    out = kernels.plan(kernels.lib().sina_graph_traceback_plan, bp.data_ptr(),
                       bp.shape[-1], n=7, device=bp.device)
    keys = ("threads", "window_nodes", "window_rows", "copy_bytes", "dyn_smem",
            "static_smem", "regs")
    return dict(zip(keys, out))


def check_walks(done: np.ndarray) -> None:
    """Raise when a traceback walk did not reach DONE in its bound."""
    bad = np.flatnonzero(np.asarray(done) == 0)
    if len(bad):
        raise RuntimeError(
            f"graph traceback did not finish for {len(bad)} queries "
            f"(rows {bad[:8].tolist()}): inconsistent backpointers"
        )
