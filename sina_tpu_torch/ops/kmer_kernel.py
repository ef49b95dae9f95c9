"""Batched k-mer scoring and exact top-k.

S[b, s] = sum_l P[kmers[b, l], s] over one of two layouts of the
incidence matrix; padding k-mers point at its all-zero last row.

- Bitpacked: P the (R+1, Sb) uint8 matrix of KmerIndex.dense_packed
  (bit b of byte j = reference 8j+b), S = 8*Sb.  A CUDA tensor launches
  csrc/kmer_score.cu (the port of sina_tpu/ops/kmer_kernel.py
  _pallas_kernel_packed and _pallas_kernel_tiled); a CPU tensor runs
  ``kmer_scores_plain``.  The tiled (R, 32, W) layout holds the same
  bytes in the same order, so it is scored as its (R, 32*W) view.
- Dense: P the (R+1, S) int8 matrix of KmerIndex.dense.  A CUDA tensor
  launches csrc/kmer_dense.cu (the port of _pallas_kernel); a CPU
  tensor runs ``kmer_scores_dense_plain``.

``kmer_scores`` dispatches on the matrix's dtype, as the JAX package's
does (sina_tpu/ops/kmer_kernel.py:371-393).
"""

from __future__ import annotations

import torch

from . import kernels

# k-mers gathered at a time by the plain versions (bounds the (B, c, S)
# gather's memory)
_CHUNK = 32


def _flat(P: torch.Tensor) -> torch.Tensor:
    # tiled (R, 32, W) == flat (R, 32*W) in logical byte order
    # (sina_tpu/ops/kmer_kernel.py:386-390)
    return P.reshape(P.shape[0], -1) if P.dim() == 3 else P


def kmer_scores_plain(P: torch.Tensor, kmers: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: chunked row gather + bit-unpack sum.
    P (R+1, Sb) uint8 (or tiled), kmers (B, L) int32 -> (B, 8*Sb)
    int32.  Ids outside [0, R] (famfinder makes none) clamp into the
    matrix, as the kernel clamps them."""
    P = _flat(P)
    B, L = kmers.shape
    Sb = P.shape[1]
    ids = kmers.long().clamp(0, P.shape[0] - 1)
    shifts = torch.arange(8, device=P.device, dtype=torch.uint8)
    acc = torch.zeros((B, Sb, 8), dtype=torch.int32, device=P.device)
    for l0 in range(0, L, _CHUNK):
        rows = P[ids[:, l0:l0 + _CHUNK]]                  # (B, c, Sb)
        bits = (rows.unsqueeze(-1) >> shifts) & 1        # (B, c, Sb, 8)
        acc += bits.sum(dim=1, dtype=torch.int32)
    return acc.reshape(B, Sb * 8)


def kmer_scores_dense_plain(P: torch.Tensor, kmers: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dense scorer: chunked row gather,
    summed in int32.  P (R+1, S) int8, kmers (B, L) int32 -> (B, S)
    int32.  Ids outside [0, R] (famfinder makes none) clamp into the
    matrix, as the kernel clamps them."""
    B, L = kmers.shape
    ids = kmers.long().clamp(0, P.shape[0] - 1)
    acc = torch.zeros((B, P.shape[1]), dtype=torch.int32, device=P.device)
    for l0 in range(0, L, _CHUNK):
        acc += P[ids[:, l0:l0 + _CHUNK]].sum(dim=1, dtype=torch.int32)
    return acc


def kmer_scores(P: torch.Tensor, kmers: torch.Tensor) -> torch.Tensor:
    """Scores (B, S) int32: a uint8 matrix (flat or tiled) is bitpacked,
    any other is dense.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if P.dtype != torch.uint8:
        return _kmer_scores_dense(P, kmers)
    P = _flat(P)
    if P.device.type == "cpu":
        return kmer_scores_plain(P, kmers)
    dev = P.device
    kernels.require_cuda("P", P, torch.uint8, dev, 2)
    kernels.require_cuda("kmers", kmers, torch.int32, dev, 2)
    R, Sb = P.shape
    B, L = kmers.shape
    if Sb % 4 or P.data_ptr() % 4:
        raise ValueError("P rows must be a multiple of 4 bytes, 4-byte aligned")
    out = torch.empty((B, 8 * Sb), dtype=torch.int32, device=dev)
    err = kernels.lib().sina_kmer_score(
        P.data_ptr(), kmers.data_ptr(), out.data_ptr(), Sb, R, B, L,
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "kmer_score")
    kernels.launches["kmer_score"] += 1
    return out


def _kmer_scores_dense(P: torch.Tensor, kmers: torch.Tensor) -> torch.Tensor:
    if P.device.type == "cpu":
        return kmer_scores_dense_plain(P, kmers)
    dev = P.device
    kernels.require_cuda("P", P, torch.int8, dev, 2)
    kernels.require_cuda("kmers", kmers, torch.int32, dev, 2)
    R, S = P.shape
    B, L = kmers.shape
    # 16-byte loads: every row must start on a 16-byte boundary
    # (KmerIndex.dense pads S to a multiple of 128)
    if S % 16 or P.data_ptr() % 16:
        raise ValueError("P rows must be a multiple of 16 bytes, 16-byte aligned")
    out = torch.empty((B, S), dtype=torch.int32, device=dev)
    err = kernels.lib().sina_kmer_score_dense(
        P.data_ptr(), kmers.data_ptr(), out.data_ptr(), S, R, B, L,
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "kmer_score_dense")
    kernels.launches["kmer_score_dense"] += 1
    return out


def top_k_lowest_id(scores: torch.Tensor, k: int):
    """Per-row top-k, descending, ties to the LOWEST id — the order of
    lax.top_k (sina_tpu/ops/kmer_kernel.py:426-432) on every device
    (torch.topk promises no tie order on CUDA).  Ranks the distinct
    int64 key (score << 32) | (0xFFFFFFFF - id).  scores (B, S) int32
    with S < 2**32 -> (values (B, k) int32, ids (B, k) int32)."""
    S = scores.shape[1]
    ids = torch.arange(S, device=scores.device, dtype=torch.int64)
    key = (scores.to(torch.int64) << 32) | (0xFFFFFFFF - ids)
    top = torch.topk(key, k, dim=1, sorted=True).values
    vals = (top >> 32).to(torch.int32)
    tid = (0xFFFFFFFF - (top & 0xFFFFFFFF)).to(torch.int32)
    return vals, tid


# padded widths from which famfinder ranks with grouped_top_k
# (sina_tpu/famfinder.py:41)
GROUPED_MIN_WIDTH = 32768


def grouped_top_k(scores: torch.Tensor, k: int):
    """The JAX package's grouped_top_k (sina_tpu/ops/kmer_kernel.py:
    396-422), step for step: maxima of groups of 8, the top C =
    min(max(k, 256), S/8) groups, the top k of their 8C members, and
    ids cand[sel // 8] * 8 + sel % 8.  Values are exact; a tie at the
    k-th value resolves by group rank, as there.  Each stage breaks
    ties to the lowest position, as lax.top_k does.  A plain top-k
    where S % 8 or 16C >= S, as there."""
    B, S = scores.shape
    C = min(max(k, 256), S // 8)
    if S % 8 or C * 8 * 2 >= S:
        return top_k_lowest_id(scores, min(k, S))
    g = scores.view(B, S // 8, 8)
    _, cand = top_k_lowest_id(g.amax(dim=2), C)
    cand = cand.long()
    sub = torch.gather(g, 1, cand[:, :, None].expand(B, C, 8)).reshape(B, 8 * C)
    vals, sel = top_k_lowest_id(sub, min(k, 8 * C))
    sel = sel.long()
    ids = torch.gather(cand, 1, sel // 8) * 8 + sel % 8
    return vals, ids.to(torch.int32)


def score_topk(P: torch.Tensor, kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Scoring + top-k in one device-resident step; returns the packed
    (B, 2k) int32 [values | ids] (one device-to-host copy), the layout
    of sina_tpu/famfinder.py _score_topk_compiled: grouped_top_k from
    GROUPED_MIN_WIDTH padded references on, a plain top-k below, so
    the ids equal the JAX package's at every size."""
    scores = kmer_scores(P, kmers)
    if scores.shape[1] >= GROUPED_MIN_WIDTH:
        vals, ids = grouped_top_k(scores, k)
    else:
        vals, ids = top_k_lowest_id(scores, k)
    return torch.cat([vals, ids], dim=1)
