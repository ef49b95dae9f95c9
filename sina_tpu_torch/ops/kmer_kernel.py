"""Batched k-mer scoring and exact top-k.

S[b, s] = sum_l P[kmers[b, l], s] over one of two layouts of the
incidence matrix; padding k-mers point at its all-zero last row.

- Bitpacked: P the (R+1, Sb) uint8 matrix of KmerIndex.dense_packed
  (bit b of byte j = reference 8j+b), S = 8*Sb.  A CUDA tensor launches
  csrc/kmer_score.cu (the port of sina_tpu/ops/kmer_kernel.py
  _pallas_kernel_packed and _pallas_kernel_tiled): a pre-pass sorts each
  query's clamped ids into (row, count) runs, so every distinct row is
  gathered once, in ascending order, by blocks launched query by query
  for each column tile; it can also write the maxima of the groups of 8
  (one byte column each) that grouped_top_k ranks first.  A CPU tensor
  runs ``kmer_scores_plain`` (and ``group_max_plain``).  The tiled
  (R, 32, W) layout holds the same bytes in the same order, so it is
  scored as its (R, 32*W) view.
- Dense: P the (R+1, S) int8 matrix of KmerIndex.dense.  A CUDA tensor
  launches csrc/kmer_dense.cu (the port of _pallas_kernel); a CPU
  tensor runs ``kmer_scores_dense_plain``.

``kmer_scores`` dispatches on the matrix's dtype, as the JAX package's
does (sina_tpu/ops/kmer_kernel.py:371-393).
"""

from __future__ import annotations

import torch

from . import kernels

# k-mers gathered at a time by the plain versions, at most
_CHUNK = 32
# bytes of the gathered rows (the bitpacked ones unpacked, a byte a bit)
# the plain versions hold at a time, so that they fit beside the index: a
# batch of 1,024 queries against the 56,320-byte rows of a 450k-reference
# index takes one k-mer of 595 queries at a time
_PLAIN_BYTES = 256 << 20


def _blocks(B: int, L: int, row_bytes: int) -> tuple[int, int]:
    """(queries, k-mers) the plain versions gather at a time: up to
    _CHUNK k-mers, fewer (down to 1, then fewer queries too) as the
    (queries, k-mers, row_bytes) block would pass _PLAIN_BYTES."""
    row_bytes = max(row_bytes, 1)
    b = max(1, min(B, _PLAIN_BYTES // row_bytes))
    c = max(1, min(_CHUNK, L, _PLAIN_BYTES // (b * row_bytes)))
    return b, c


def _flat(P: torch.Tensor) -> torch.Tensor:
    # tiled (R, 32, W) == flat (R, 32*W) in logical byte order
    # (sina_tpu/ops/kmer_kernel.py:386-390)
    return P.reshape(P.shape[0], -1) if P.dim() == 3 else P


def kmer_scores_plain(P: torch.Tensor, kmers: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: blocked row gather + bit-unpack sum.
    P (R+1, Sb) uint8 (or tiled), kmers (B, L) int32 -> (B, 8*Sb)
    int32.  Ids outside [0, R] (famfinder makes none) clamp into the
    matrix, as the kernel clamps them."""
    P = _flat(P)
    B, L = kmers.shape
    Sb = P.shape[1]
    ids = kmers.long().clamp(0, P.shape[0] - 1)
    shifts = torch.arange(8, device=P.device, dtype=torch.uint8)
    acc = torch.zeros((B, Sb, 8), dtype=torch.int32, device=P.device)
    nb, c = _blocks(B, L, 8 * Sb)
    for b0 in range(0, B, nb):
        for l0 in range(0, L, c):
            bits = P[ids[b0:b0 + nb, l0:l0 + c]].unsqueeze(-1) >> shifts  # (nb, c, Sb, 8)
            bits &= 1
            acc[b0:b0 + nb] += bits.sum(dim=1, dtype=torch.int32)
    return acc.reshape(B, Sb * 8)


def group_max_plain(scores: torch.Tensor) -> torch.Tensor:
    """Plain version of the bitpacked scorer's second output: the
    maximum of each group of 8 scores (one byte column of the matrix),
    the first stage of grouped_top_k (sina_tpu/ops/kmer_kernel.py:
    412-413).  scores (B, 8*Sb) int32 -> (B, Sb) int32."""
    B, S = scores.shape
    return scores.view(B, S // 8, 8).amax(dim=2)


def kmer_scores_dense_plain(P: torch.Tensor, kmers: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dense scorer: blocked row gather,
    summed in int32.  P (R+1, S) int8, kmers (B, L) int32 -> (B, S)
    int32.  Ids outside [0, R] (famfinder makes none) clamp into the
    matrix, as the kernel clamps them."""
    B, L = kmers.shape
    ids = kmers.long().clamp(0, P.shape[0] - 1)
    acc = torch.zeros((B, P.shape[1]), dtype=torch.int32, device=P.device)
    nb, c = _blocks(B, L, P.shape[1])
    for b0 in range(0, B, nb):
        for l0 in range(0, L, c):
            acc[b0:b0 + nb] += P[ids[b0:b0 + nb, l0:l0 + c]].sum(dim=1, dtype=torch.int32)
    return acc


def kmer_scores(P: torch.Tensor, kmers: torch.Tensor, gmax: bool = False):
    """Scores (B, S) int32: a uint8 matrix (flat or tiled) is bitpacked,
    any other is dense.  With gmax (bitpacked only), returns (scores,
    group maxima (B, S/8) int32), both from one kernel launch.  CPU
    tensors take the plain versions; CUDA tensors launch the kernel (or
    raise)."""
    if P.dtype != torch.uint8:
        if gmax:
            raise TypeError("gmax needs the bitpacked (uint8) matrix")
        return _kmer_scores_dense(P, kmers)
    P = _flat(P)
    if P.device.type == "cpu":
        scores = kmer_scores_plain(P, kmers)
        return (scores, group_max_plain(scores)) if gmax else scores
    dev = P.device
    kernels.require_cuda("P", P, torch.uint8, dev, 2)
    kernels.require_cuda("kmers", kmers, torch.int32, dev, 2)
    R, Sb = P.shape
    B, L = kmers.shape
    # the kernel copies 16 bytes at once where Sb and P's address allow, else 4
    if Sb % 4 or P.data_ptr() % 4:
        raise ValueError("P rows must be a multiple of 4 bytes, 4-byte aligned")
    out = torch.empty((B, 8 * Sb), dtype=torch.int32, device=dev)
    gm = torch.empty((B, Sb), dtype=torch.int32, device=dev) if gmax else None
    # the pre-pass's (row, count) runs: rows (B, L), counts (B, L), runs (B,)
    runs = torch.empty(2 * B * L + B, dtype=torch.int32, device=dev)
    kernels.launch(
        "kmer_score", kernels.lib().sina_kmer_score,
        P.data_ptr(), kmers.data_ptr(), out.data_ptr(),
        gm.data_ptr() if gmax else None, runs.data_ptr(), Sb, R, B, L,
        device=dev,
    )
    return (out, gm) if gmax else out


def kmer_score_plan(P: torch.Tensor) -> dict:
    """The bitpacked scorer's launch plan for the matrix P (needs the
    card): bytes a thread copies from a row at once (16 where P's rows
    and address allow, else 4), threads a block, chunks a tile,
    tiles a row, registers, static and dynamic (the ring) shared memory,
    spilled bytes, blocks an SM, runs a group and groups a ring, the
    pre-pass's threads and ids sorted together, and the bytes the ring's
    copies can keep in flight on an SM."""
    P = _flat(P)
    out = kernels.plan(kernels.lib().sina_kmer_score_plan, P.shape[1], P.data_ptr(), n=13,
                       device=P.device)
    keys = ("load_bytes", "threads", "tile_chunks", "tiles", "regs", "static_smem",
            "dyn_smem", "spill_bytes", "blocks_per_sm", "group", "ring", "sort_threads",
            "sort_chunk")
    plan = dict(zip(keys, out))
    plan["bytes_in_flight_per_sm"] = (plan["blocks_per_sm"] * plan["tile_chunks"]
                                      * plan["load_bytes"] * plan["group"]
                                      * (plan["ring"] - 1))
    return plan


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
    kernels.launch(
        "kmer_score_dense", kernels.lib().sina_kmer_score_dense,
        P.data_ptr(), kmers.data_ptr(), out.data_ptr(), S, R, B, L, device=dev,
    )
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


def grouped_top_k(scores: torch.Tensor, k: int, gmax: torch.Tensor | None = None):
    """The JAX package's grouped_top_k (sina_tpu/ops/kmer_kernel.py:
    396-422), step for step: maxima of groups of 8 (taken from `gmax`,
    the bitpacked scorer's second output, when given, else computed
    here), the top C = min(max(k, 256), S/8) groups, the top k of their
    8C members, and ids cand[sel // 8] * 8 + sel % 8.  Values are exact;
    a tie at the k-th value resolves by group rank, as there.  Each
    stage breaks ties to the lowest position, as lax.top_k does.  A
    plain top-k where S % 8 or 16C >= S, as there."""
    B, S = scores.shape
    C = min(max(k, 256), S // 8)
    if S % 8 or C * 8 * 2 >= S:
        return top_k_lowest_id(scores, min(k, S))
    g = scores.view(B, S // 8, 8)
    _, cand = top_k_lowest_id(g.amax(dim=2) if gmax is None else gmax, C)
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
    GROUPED_MIN_WIDTH padded references on (its group maxima written by
    the bitpacked scorer; for the dense matrix it computes them), a
    plain top-k below, so the ids equal the JAX package's at every
    size."""
    if P.dtype == torch.uint8:
        scores, gmax = kmer_scores(P, kmers, gmax=True)
    else:
        scores, gmax = kmer_scores(P, kmers), None
    if scores.shape[1] >= GROUPED_MIN_WIDTH:
        vals, ids = grouped_top_k(scores, k, gmax)
    else:
        vals, ids = top_k_lowest_id(scores, k)
    return torch.cat([vals, ids], dim=1)
