"""The fused profile chain DP and its traceback.

``profile_dp`` launches csrc/profile_dp.cu (the port of
sina_tpu/ops/profile_pallas.py _fused_kernel, with the quantised
profile unpack of sina_tpu/ops/profile.py _device_unpack_fgq and the
dedup fam_idx gather folded in) for CUDA tensors, and runs the plain
version ``profile_dp_plain`` for CPU tensors.  ``chain_traceback``
launches csrc/chain_traceback.cu (the port of
profile_pallas.chain_traceback_log + the host scatter
profile._unpack_log_result) or runs ``chain_traceback_plain``.

Semantics are the Pallas kernel's, including its ``ins_opened`` test
``(Uprev + go) <= (Iprev + ge)`` — the XLA chain_dp additionally ORs
in ``Irow + 1e-4 < Iprev + ge`` (sina_tpu/ops/profile.py:468-470); the
TPU ran the Pallas semantics.

Layouts: fgq (U, C, 6) uint8 quantised profiles (4 freq bytes x/255 +
int16 gap cost / gap_scale); qmask (B, M) uint8 IUPAC masks; lens
(B, 2) int32 = (qlen, c_real); fam_idx (B,) int32 or None (row b
reads profile fam_idx[b], else profile b); bp (C, B, M) uint8 (bits
0-1 code, bit 2 deletion opened, bit 3 insertion opened).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .align_kernel import BIG, CODE_DEL, CODE_EDGE, CODE_INS, CODE_MATCH, DpParams

# traceback states (sina_tpu/ops/profile_pallas.py:299-304)
_S_RESOLVE = 0
_S_CHAIN = 1
_S_DECIDE = 2
_S_INS = 3
_S_CHAIN_NE = 5
_S_DONE = 6


def gap_scale(params: DpParams) -> float:
    """Static fixed-point scale of the int16 gap-cost transfer
    (sina_tpu/ops/profile.py:511-516)."""
    return 32000.0 / max(params.gap_open + params.gap_ext, 1.0)


def _scalars(params: DpParams) -> dict[str, float]:
    # each constant is rounded to f32 from a Python double, as the
    # Pallas kernel's static floats are
    return {
        "go": params.gap_open,
        "ge": params.gap_ext,
        "m_minus_mm": params.match - params.mismatch,
        "mm": params.mismatch,
        "inv255": 1.0 / 255.0,
        "inv_gap_scale": 1.0 / gap_scale(params),
    }


def unpack_fgq(fgq: torch.Tensor, params: DpParams):
    """Invert _pack_fgq: (freqs (U, C, 4) f32, gapcost (U, C) f32)."""
    s = _scalars(params)
    f32 = torch.float32
    fq = fgq[..., :4].to(f32) * torch.tensor(s["inv255"], dtype=f32, device=fgq.device)
    gq = fgq[..., 4:6].contiguous().view(torch.int16)[..., 0]
    gc = gq.to(f32) * torch.tensor(s["inv_gap_scale"], dtype=f32, device=fgq.device)
    return fq, gc


def _shift_right(x: torch.Tensor, n: int, fill: torch.Tensor) -> torch.Tensor:
    return torch.cat([fill.expand(x.shape[0], n), x[:, :-n]], dim=1)


def profile_dp_plain(fgq, qmask, lens, params: DpParams, fam_idx=None):
    """Plain PyTorch version: a Python loop over the C columns on
    (B, M) tensors, the insertion prefix-min by doubling, every f32
    operation in the Pallas kernel's order.  Returns (bp (C, B, M)
    uint8, best_c (B,) int32, best_i (B,) int32, raw (B,) f32)."""
    dev = qmask.device
    f32 = torch.float32
    s = _scalars(params)

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)

    go, ge, m_mm, mm = c(s["go"]), c(s["ge"]), c(s["m_minus_mm"]), c(s["mm"])
    big, one, zero = c(BIG), c(1.0), c(0.0)

    fq, gc = unpack_fgq(fgq, params)
    if fam_idx is not None:
        idx = fam_idx.long()
        fq, gc = fq[idx], gc[idx]
    B, M = qmask.shape
    C = fgq.shape[1]
    qm = qmask.to(torch.int32)
    qbits = [((qm >> k) & 1).to(f32) for k in range(4)]
    cnt = ((qm & 1) + ((qm >> 1) & 1) + ((qm >> 2) & 1) + ((qm >> 3) & 1)).to(f32)
    inv = torch.where(cnt > 0, one / torch.maximum(cnt, one), zero)
    qs = cnt * inv
    w = [qb * inv for qb in qbits]
    occ = fq[..., 0] + fq[..., 1] + fq[..., 2] + fq[..., 3]  # (B, C)
    dgo, dge, mmocc = go * occ, ge * occ, mm * occ
    ql = lens[:, 0:1].to(torch.int64)
    cr = lens[:, 1:2].to(torch.int64)

    lane = torch.arange(M, device=dev)
    flane = lane.to(f32)
    ramp1 = (flane + 1.0) * ge
    ramp = flane * ge
    base_first = torch.full((B, M), 1.0, dtype=f32, device=dev)
    base_rest = torch.where(lane == 0, one, big).expand(B, M)
    big1 = big.reshape(1, 1)

    Vp = torch.full((B, M), BIG, dtype=f32, device=dev)
    Dp = torch.full((B, M), BIG, dtype=f32, device=dev)
    b1v = torch.full((B,), BIG, dtype=f32, device=dev)
    b1j = torch.zeros(B, dtype=torch.int64, device=dev)
    b2v = torch.full((B,), BIG, dtype=f32, device=dev)
    b2i = torch.zeros(B, dtype=torch.int64, device=dev)
    bp = torch.empty((C, B, M), dtype=torch.uint8, device=dev)
    cr1 = cr[:, 0]
    for j in range(C):
        f = fq[:, j, :]
        dot = (f[:, 0:1] * w[0] + f[:, 1:2] * w[1] + f[:, 2:3] * w[2]
               + f[:, 3:4] * w[3])
        sub = m_mm * dot + mmocc[:, j:j + 1] * qs + gc[:, j:j + 1]
        sub = torch.where(j >= cr, big, sub)
        base = base_first if j == 0 else base_rest

        d_open = Vp + dgo[:, j:j + 1]
        d_ext = Dp + dge[:, j:j + 1]
        dmin = torch.minimum(d_open, d_ext)
        dsel_open = d_open < d_ext
        Drow = torch.minimum(base, dmin)
        Mc = _shift_right(Vp, 1, big1) + sub

        take_d = dmin < base
        U = torch.where(take_d, dmin, base)
        code = torch.where(take_d, CODE_DEL, CODE_EDGE)
        take_m = Mc < U
        U = torch.where(take_m, Mc, U)
        code = torch.where(take_m, CODE_MATCH, code)

        x = U + go - ramp1
        n = 1
        while n < M:
            x = torch.minimum(x, _shift_right(x, n, big1))
            n *= 2
        Irow = torch.minimum(_shift_right(x, 1, big1), one) + ramp
        ins_opened = (_shift_right(U, 1, big1) + go) <= (_shift_right(Irow, 1, big1) + ge)
        take_i = Irow <= U
        Vrow = torch.where(take_i, Irow, U)
        code = torch.where(take_i, CODE_INS, code)
        bp[j] = (code | (dsel_open.to(torch.int64) << 2)
                 | (ins_opened.to(torch.int64) << 3)).to(torch.uint8)

        # end selection (mesh.h:569-592; profile_pallas.py:156-183)
        val1 = torch.where(lane == ql - 1, Vrow, big).amin(dim=1)
        upd1 = (j < cr1) & (val1 < b1v)
        b1v = torch.where(upd1, val1, b1v)
        b1j = torch.where(upd1, j, b1j)
        c2row = torch.where(lane < ql, Vrow, big)
        v2 = c2row.amin(dim=1)
        i2 = torch.where(c2row == v2[:, None], lane, M).amin(dim=1)
        upd2 = j == cr1 - 1
        b2v = torch.where(upd2, v2, b2v)
        b2i = torch.where(upd2, i2, b2i)
        Vp, Dp = Vrow, Drow

    use2 = b2v < b1v
    best_c = torch.where(use2, cr1 - 1, b1j).to(torch.int32)
    best_i = torch.where(use2, b2i, ql[:, 0] - 1).to(torch.int32)
    raw = torch.where(use2, b2v, b1v)
    return bp, best_c, best_i, raw


def profile_dp(fgq, qmask, lens, params: DpParams, fam_idx=None):
    """The fused profile DP; see profile_dp_plain for the contract.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if qmask.device.type == "cpu":
        return profile_dp_plain(fgq, qmask, lens, params, fam_idx)
    dev = qmask.device
    kernels.require_cuda("fgq", fgq, torch.uint8, dev, 3)
    kernels.require_cuda("qmask", qmask, torch.uint8, dev, 2)
    kernels.require_cuda("lens", lens, torch.int32, dev, 2)
    if fam_idx is not None:
        kernels.require_cuda("fam_idx", fam_idx, torch.int32, dev, 1)
    B, M = qmask.shape
    U, C, six = fgq.shape
    if six != 6 or lens.shape != (B, 2):
        raise ValueError(f"bad shapes: fgq {tuple(fgq.shape)}, lens {tuple(lens.shape)}")
    if fam_idx is None and U != B or fam_idx is not None and fam_idx.shape != (B,):
        raise ValueError("fgq rows must match the batch, or fam_idx map it")
    if M % 4 or not 0 < M <= 16384:
        raise ValueError(f"profile_dp kernel needs M % 4 == 0 and M <= 16384 (M={M})")
    bp = torch.empty((C, B, M), dtype=torch.uint8, device=dev)
    best_c = torch.empty(B, dtype=torch.int32, device=dev)
    best_i = torch.empty(B, dtype=torch.int32, device=dev)
    raw = torch.empty(B, dtype=torch.float32, device=dev)
    s = _scalars(params)
    err = kernels.lib().sina_profile_dp(
        fgq.data_ptr(), fam_idx.data_ptr() if fam_idx is not None else None,
        qmask.data_ptr(), lens.data_ptr(), bp.data_ptr(), best_c.data_ptr(),
        best_i.data_ptr(), raw.data_ptr(), B, C, M,
        s["go"], s["ge"], s["m_minus_mm"], s["mm"], s["inv255"],
        s["inv_gap_scale"], kernels.stream_ptr(dev),
    )
    kernels.check(err, "profile_dp")
    kernels.launches["profile_dp"] += 1
    return bp, best_c, best_i, raw


def profile_dp_plan(M: int) -> dict:
    """The profile DP kernel's launch plan (needs the card): lanes a
    thread, threads, static shared memory bytes a block, registers a
    thread."""
    lib = kernels.lib()
    out = kernels.plan(lib.sina_profile_dp_plan, M, n=4)
    return dict(zip(("lanes", "threads", "static_smem", "regs"), out))


def _walk(bp_b: np.ndarray, j: int, i: int, emit_b: np.ndarray) -> int:
    """One query's traceback state machine
    (sina_tpu/ops/profile_pallas.py:324-389), writing emit[i] = j for
    each consumed query base i.  bp_b (C, M) uint8.  Returns the steps
    it took (at most C + 2M + 8)."""
    C, M = bp_b.shape
    state = _S_RESOLVE
    steps = C + 2 * M + 8
    for step in range(steps):
        if state == _S_DONE:
            return step
        cell = int(bp_b[min(max(j, 0), C - 1), min(max(i, 0), M - 1)])
        code = cell & 3
        at_edge = i == 0 or j == 0
        ei = -1
        ej = j
        if state == _S_RESOLVE:
            is_del = code == CODE_DEL and not at_edge
            state = _S_CHAIN if is_del else _S_DECIDE
            ei = -1 if is_del else i
        elif state in (_S_CHAIN, _S_CHAIN_NE):
            pj = max(j - 1, 0)
            if (cell >> 2) & 1 or pj == 0:
                state = _S_RESOLVE if state == _S_CHAIN else _S_DECIDE
            j = pj
        elif state == _S_DECIDE:
            done = at_edge or code == CODE_EDGE
            if done:
                state = _S_DONE
            elif code == CODE_MATCH:
                j, i = j - 1, i - 1
                state = _S_RESOLVE
            else:
                state = _S_INS if code == CODE_INS else _S_CHAIN_NE
        else:  # _S_INS
            ni = i - 1
            i = max(ni, 0)
            if ni < 0:
                state = _S_DONE
            else:
                state = _S_DECIDE if (cell >> 3) & 1 else _S_INS
                ei = i
        if 0 <= ei < M:
            emit_b[ei] = ej
    return steps


def chain_traceback_plain(bp, best_c, best_i, steps=None) -> torch.Tensor:
    """Plain version: the per-query state-machine walk on host arrays.
    bp (C, B, M) uint8, best_c/best_i (B,) -> emit (B, M) int32 on
    bp's device (-1 = base not consumed).  A (B,) numpy array `steps`
    receives each walk's step count."""
    C, B, M = bp.shape
    bpn = bp.cpu().numpy()
    bc = best_c.cpu().numpy()
    bi = best_i.cpu().numpy()
    emit = np.full((B, M), -1, dtype=np.int32)
    for b in range(B):
        n = _walk(bpn[:, b, :], int(bc[b]), int(bi[b]), emit[b])
        if steps is not None:
            steps[b] = n
    return torch.from_numpy(emit).to(bp.device)


def chain_traceback(bp, best_c, best_i) -> torch.Tensor:
    """emit (B, M) int32: the profile column that consumed each query
    base.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if bp.device.type == "cpu":
        return chain_traceback_plain(bp, best_c, best_i)
    dev = bp.device
    kernels.require_cuda("bp", bp, torch.uint8, dev, 3)
    kernels.require_cuda("best_c", best_c, torch.int32, dev, 1)
    kernels.require_cuda("best_i", best_i, torch.int32, dev, 1)
    C, B, M = bp.shape
    emit = torch.empty((B, M), dtype=torch.int32, device=dev)
    err = kernels.lib().sina_chain_traceback(
        bp.data_ptr(), best_c.data_ptr(), best_i.data_ptr(), emit.data_ptr(),
        B, C, M, kernels.stream_ptr(dev),
    )
    kernels.check(err, "chain_traceback")
    kernels.launches["chain_traceback"] += 1
    return emit


def chain_traceback_plan(bp: torch.Tensor) -> dict:
    """The chain traceback kernel's launch plan for the plane bp (needs
    the card): threads, the staged window's columns and query
    positions, bytes a window copy moves at once (16 where bp's columns
    are 16-byte aligned, else 4 or 1), dynamic and static shared memory
    bytes a block, registers a thread."""
    out = kernels.plan(kernels.lib().sina_chain_traceback_plan, bp.data_ptr(),
                       bp.shape[-1], n=7)
    keys = ("threads", "window_cols", "window_rows", "copy_bytes", "dyn_smem",
            "static_smem", "regs")
    return dict(zip(keys, out))
