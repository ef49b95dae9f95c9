"""Plain reference of the graph (mseq) engine: the family's POA graph,
the graph DP of a query against it, and the DP's traceback.

The semantics are SINA's mseq (mseq.cpp:46-118: one node per (column,
base) of the family, weight 1/(fw+1) + fw x count/members, edges along
each member's bases) and the JAX package's graph DP (graph_pallas.py):
a semi-global DP over query positions x nodes in topological order,
minimising (match -2 / mismatch 1 times the node weight, gap open 5,
extend 2); a cell's match and deletion moves look at the node's
predecessors in ascending distance, ties to the farthest; the insertion
track is a prefix minimum along the query.  float32, with the
reference's single roundings of its multiply-adds; `dtype` runs the
same arithmetic in another precision (the control).

Plain PyTorch and NumPy; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

GAP_OPEN, GAP_EXT, MATCH, MISMATCH = 5.0, 2.0, -2.0, 1.0
BIG = 1e6
CODE_EDGE, CODE_MATCH, CODE_DEL, CODE_INS = 0, 1, 2, 3
MAX_PREDS = 8
# backpointer word: bits 0-1 the move, 2-12 the match move's predecessor
# distance, 13-23 the deletion's, 24 deletion opened, 25 insertion opened
_MD, _DD, _DO, _IO = 2, 13, 24, 25
_F11 = 0x7FF


def build_graph(members: list[tuple[np.ndarray, np.ndarray]], fs_weight: float = 1.0) -> dict:
    """The family's graph in topological (column, base) order: pos,
    mask, weight, preds (N, 8) (-1 pad, ascending), start, end."""
    all_pos = np.concatenate([p for p, _ in members]).astype(np.int64)
    all_mask = np.concatenate([m for _, m in members]) & 0xF
    key = all_pos << 8 | all_mask.astype(np.int64)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    n = len(uniq)
    weight = (np.float32(1.0 / (fs_weight + 1.0))
              + (np.float32(fs_weight) * counts.astype(np.float32)) / np.float32(len(members))
              ).astype(np.float32)
    src, dst, off = [], [], 0
    for p, _ in members:
        ids = inv[off:off + len(p)]
        off += len(p)
        src.append(ids[:-1])
        dst.append(ids[1:])
    e = np.unique(np.concatenate(src) * n + np.concatenate(dst))
    src, dst = e // n, e % n
    preds = np.full((n, MAX_PREDS), -1, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    ds, ss = dst[order], src[order]
    rank = np.arange(len(ds)) - np.searchsorted(ds, ds, side="left")
    keep = rank < MAX_PREDS
    preds[ds[keep], rank[keep]] = ss[keep]
    start = np.bincount(dst, minlength=n) == 0
    end = np.bincount(src, minlength=n) == 0
    return {"pos": (uniq >> 8).astype(np.int64), "mask": (uniq & 0xFF).astype(np.uint8),
            "weight": weight, "preds": preds, "start": start, "end": end}


def graph_dp(graphs: list[dict], queries: list[np.ndarray], device, dtype=torch.float32):
    """The DP over a batch of (graph, query) pairs.  Returns (bp (B, N,
    M) int32 backpointers, best_j, best_i (B,) int64, raw (B,))."""
    dev = torch.device(device)
    B = len(graphs)
    N = max(len(g["pos"]) for g in graphs)
    M = max(len(q) for q in queries)
    wide = torch.float64 if dtype == torch.float32 else torch.float32
    weight = np.zeros((B, N), np.float32)
    nmask = np.zeros((B, N), np.int64)
    start = np.zeros((B, N), bool)
    valid = np.zeros((B, N), bool)
    endv = np.zeros((B, N), bool)
    preds = np.full((B, N, MAX_PREDS), -1, np.int64)
    qmask = np.zeros((B, M), np.int64)
    qlen = np.zeros(B, np.int64)
    for b, (g, q) in enumerate(zip(graphs, queries)):
        n = len(g["pos"])
        weight[b, :n] = g["weight"]
        nmask[b, :n] = g["mask"]
        start[b, :n] = g["start"]
        valid[b, :n] = True
        endv[b, :n] = g["end"]
        preds[b, :n] = g["preds"]
        qmask[b, :len(q)] = q & 0xF
        qlen[b] = len(q)
    # each node's predecessor distances, ascending (ties go to the
    # farthest predecessor: the later probe wins with <=)
    dist = np.where(preds >= 0, np.arange(N)[None, :, None] - preds, 0)
    probes = []
    for j in range(N):
        ds = np.unique(dist[:, j][dist[:, j] > 0])
        probes.append([(int(d), torch.from_numpy(~(dist[:, j] == d).any(axis=1))
                        .to(dev)[:, None]) for d in ds])

    def t(a, dt=None):
        x = torch.from_numpy(a).to(dev)
        return x if dt is None else x.to(dt)

    w_t, nm_t, st_t, va_t, en_t = t(weight), t(nmask), t(start), t(valid), t(endv)
    qm_t, ql_t = t(qmask), t(qlen)

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    go, ge, big = c(GAP_OPEN), c(GAP_EXT), c(BIG)
    subw = w_t.to(dtype)  # column weights all 1: the node weight alone
    lane = torch.arange(M, device=dev)
    fl_w = lane.to(dtype).to(wide)[None]
    negfl1_w = (-(lane.to(dtype) + 1.0)).to(wide)[None]
    vlm = lane[None] < ql_t[:, None]
    rows = torch.arange(B, device=dev)
    ql1 = (ql_t - 1).clamp(min=0)
    one = c(1.0)
    bigrow = torch.full((B, M), BIG, dtype=dtype, device=dev)
    base0 = torch.full((1, M), BIG, dtype=dtype, device=dev)
    base0[0, 0] = 1.0
    inf = float("inf")
    V = [None] * N
    D = [None] * N
    c1v = torch.full((B,), BIG, dtype=dtype, device=dev)
    c1j = torch.zeros(B, dtype=torch.int64, device=dev)
    c2v = bigrow.clone()
    c2j = torch.zeros((B, M), dtype=torch.int64, device=dev)
    bp = torch.empty((B, N, M), dtype=torch.int32, device=dev)

    def shift(x, fill):
        return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)

    for j in range(N):
        vmin = dmin = bigrow
        mdist = torch.zeros((B, M), dtype=torch.int32, device=dev)
        ddist = torch.zeros((B, M), dtype=torch.int32, device=dev)
        dopen = torch.zeros((B, M), dtype=torch.bool, device=dev)
        for d, lack in probes[j]:
            Vp = V[j - d]
            vc = Vp.masked_fill(lack, inf)
            mdist.masked_fill_(vc <= vmin, d)
            vmin = torch.minimum(vmin, vc)
            do_ = Vp + go
            de_ = D[j - d] + ge
            dc = torch.minimum(do_, de_).masked_fill(lack, inf)
            upd = dc <= dmin
            ddist.masked_fill_(upd, d)
            dopen = torch.where(upd, do_ < de_, dopen)
            dmin = torch.minimum(dmin, dc)
        base = torch.where(st_t[:, j:j + 1], one, base0)
        Drow = torch.minimum(base, dmin)
        sfac = torch.where((nm_t[:, j:j + 1] & qm_t) != 0, c(MATCH), c(MISMATCH))
        Mc = (shift(vmin, BIG).to(wide) + sfac.to(wide) * subw[:, j:j + 1].to(wide)).to(dtype)
        code = (dmin < base).to(torch.int32) * CODE_DEL
        U = Drow
        code.masked_fill_(Mc < U, CODE_MATCH)
        U = torch.minimum(U, Mc)
        cand = ((U + go).to(wide) + negfl1_w * ge.to(wide)).to(dtype)
        prefix = shift(torch.cummin(cand, dim=1).values, BIG).clamp(max=1.0)
        Irow = (prefix.to(wide) + fl_w * ge.to(wide)).to(dtype)
        ins_opened = (shift(U, BIG) + go) <= (shift(Irow, BIG) + ge)
        code.masked_fill_(Irow <= U, CODE_INS)
        Vrow = torch.minimum(Irow, U)
        code += shift(mdist, 0) << _MD
        code += ddist << _DD
        code += dopen.to(torch.int32) << _DO
        code += ins_opened.to(torch.int32) << _IO
        bp[:, j] = code
        V[j], D[j] = Vrow, Drow
        c1cand = torch.where(va_t[:, j], Vrow[rows, ql1], big)
        upd1 = c1cand < c1v
        c1v = torch.minimum(c1v, c1cand)
        c1j.masked_fill_(upd1, j)
        c2cand = torch.where(en_t[:, j:j + 1] & va_t[:, j:j + 1] & vlm, Vrow, big)
        c2j.masked_fill_(c2cand < c2v, j)
        c2v = torch.minimum(c2v, c2cand)
    v2 = c2v.amin(dim=1)
    at2 = c2v == v2[:, None]
    jbig = torch.full_like(c2j, N + 1)
    j2 = torch.where(at2, c2j, jbig).amin(dim=1)
    i2 = torch.where(at2 & (c2j == j2[:, None]), lane[None].expand(B, M), M).amin(dim=1)
    j1 = torch.where(c1v >= BIG, 0, c1j)
    j2 = torch.where(v2 >= BIG, 0, j2)
    i2 = torch.where(v2 >= BIG, 0, i2)
    use2 = v2 < c1v
    best_j = torch.where(use2, j2, j1)
    best_i = torch.where(use2, i2, ql_t - 1)
    raw = torch.where(use2, v2, c1v)
    return bp, best_j, best_i, raw


_RESOLVE, _CHAIN, _DECIDE, _INS, _RESOLVE_NE, _CHAIN_NE, _DONE = 0, 1, 2, 3, 4, 5, 6


def traceback(bp_b: np.ndarray, start_b: np.ndarray, j: int, i: int) -> np.ndarray:
    """One query's walk back from (node j, base i) through its (N, M)
    backpointers: emit[i] is the node that took base i (-1: none)."""
    N, M = bp_b.shape
    emit = np.full(M, -1, dtype=np.int64)
    state = _RESOLVE
    for _ in range(N + 2 * M + 8):
        if state == _DONE:
            break
        jj = min(max(j, 0), N - 1)
        cell = int(bp_b[jj, min(max(i, 0), M - 1)])
        code = cell & 3
        at_edge = i == 0 or bool(start_b[jj])
        if state in (_RESOLVE, _RESOLVE_NE):
            is_del = code == CODE_DEL and not at_edge
            if state == _RESOLVE and not is_del and 0 <= i < M:
                emit[i] = j
            state = (_CHAIN if state == _RESOLVE else _CHAIN_NE) if is_del else _DECIDE
        elif state in (_CHAIN, _CHAIN_NE):
            dd = (cell >> _DD) & _F11
            pj = max(j - dd if dd > 0 else j, 0)
            if (cell >> _DO) & 1 or start_b[min(pj, N - 1)]:
                state = _RESOLVE if state == _CHAIN else _RESOLVE_NE
            j = pj
        elif state == _DECIDE:
            if at_edge or code == CODE_EDGE:
                state = _DONE
            elif code == CODE_MATCH:
                md = (cell >> _MD) & _F11
                j = max(j - md if md > 0 else j, 0)
                i -= 1
                state = _RESOLVE
            else:
                state = _INS if code == CODE_INS else _CHAIN_NE
        else:
            ni = i - 1
            if ni < 0:
                state = _DONE
            else:
                i = ni
                if i < M:
                    emit[i] = j
                state = _DECIDE if (cell >> _IO) & 1 else _INS
    return emit
