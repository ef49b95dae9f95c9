"""Plain reference of family selection: k-mer scores of a query against
every reference, the ranking and the family policy.

SINA's internal k-mer engine (kmer_search.cpp:152-276,366-420): each
reference holds the set of its distinct 10-mers that start with A
("fast" mode, the first base dropped from the value), a query scores
one point per k-mer occurrence (with multiplicity) that a reference
holds; candidates rank by score, ties as the JAX package's top-k
breaks them (see ranking).  The family
policy is famfinder.cpp:497-612: the first fs_min candidates of at
least fs_min_len bases, then, up to fs_max, those scoring below fs_msc,
and candidates that fill the full-length quota; the candidate list
deepens tenfold until the quotas hold; then members with fewer than
fs_req_gaps internal gap columns go.  The turn check
(famfinder.cpp:344-378) scores a query in each orientation it tries and
keeps the one whose best score against any reference is highest.  Plain
PyTorch on the arrays the benchmark generated; imports nothing of the
program.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

# base index of each mask (A G C U = 0 1 2 3)
_IDX = torch.full((256,), -1, dtype=torch.int64)
for _i, _m in enumerate((1, 2, 4, 8)):
    _IDX[_m] = _i


def _kmer_values(masks: torch.Tensor, valid: torch.Tensor, k: int):
    """Values of the A-prefixed k-mers starting at each position of the
    flat mask array whose window lies inside one sequence (`valid`),
    and the mask of those that are kept."""
    idx = _IDX.to(masks.device)[masks.long()]
    n = masks.numel()
    # an ambiguity code in the window drops the k-mer (kmer.h:46-151)
    ok = valid & (idx == 0)
    v = torch.zeros(n, dtype=torch.int64, device=masks.device)
    for j in range(1, k):
        sh = torch.zeros_like(v)
        sh[: n - j] = idx[j:]
        ok &= sh >= 0
        v = v * 4 + sh.clamp(min=0)
    return v, ok


def _window_valid(offsets: torch.Tensor, k: int) -> torch.Tensor:
    n = int(offsets[-1])
    lens = offsets[1:] - offsets[:-1]
    seq = torch.repeat_interleave(torch.arange(lens.numel(), device=offsets.device), lens)
    pos = torch.arange(n, device=offsets.device) - offsets[:-1][seq]
    return pos + k <= lens[seq]


class RefKmers:
    """Every reference's distinct A-prefixed k-mers, as (reference-
    sorted) value arrays with per-reference offsets."""

    def __init__(self, masks: torch.Tensor, offsets: torch.Tensor, k: int = 10,
                 chunk: int = 16384):
        dev = masks.device
        n = offsets.numel() - 1
        vals, counts = [], []
        for r0 in range(0, n, chunk):
            r1 = min(n, r0 + chunk)
            lo, hi = int(offsets[r0]), int(offsets[r1])
            off = offsets[r0:r1 + 1] - lo
            v, ok = _kmer_values(masks[lo:hi], _window_valid(off, k), k)
            seq = torch.repeat_interleave(torch.arange(r1 - r0, device=dev), off[1:] - off[:-1])
            key = torch.unique(seq[ok] * 4 ** (k - 1) + v[ok])
            vals.append((key % 4 ** (k - 1)).to(torch.int32))
            counts.append(torch.bincount(key // 4 ** (k - 1), minlength=r1 - r0))
        self.k = k
        self.n = n
        self.vals = torch.cat(vals)
        self.offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        self.offsets[1:] = torch.cumsum(torch.cat(counts), 0)
        self._incidence = None  # made by the first top1()

    def scores(self, qmasks: torch.Tensor) -> torch.Tensor:
        """(n,) int64: one query's score against every reference."""
        k = self.k
        off = torch.tensor([0, qmasks.numel()], device=qmasks.device)
        v, ok = _kmer_values(qmasks, _window_valid(off, k), k)
        cnt = torch.bincount(v[ok], minlength=4 ** (k - 1))
        per = cnt[self.vals.long()].cumsum(0)
        ends = per[self.offsets[1:] - 1]
        starts = torch.zeros_like(ends)
        starts[1:] = ends[:-1]
        empty = self.offsets[1:] == self.offsets[:-1]
        return torch.where(empty, 0, ends - starts)

    def top1(self, queries: list[torch.Tensor], chunk: int = 256) -> torch.Tensor:
        """(len(queries),) int64: each query's best score against any
        reference, for all queries in one call: the references' k-mer
        incidence (sparse, a row a reference) times the queries' k-mer
        counts (a column a query), which float32 sums exactly at these
        magnitudes (under 2**24)."""
        k, dev = self.k, self.vals.device
        if self._incidence is None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # sparse CSR is "beta"
                self._incidence = torch.sparse_csr_tensor(
                    self.offsets.to(torch.int32), self.vals,
                    torch.ones(self.vals.numel(), device=dev), size=(self.n, 4 ** (k - 1)))
        out = []
        for q0 in range(0, len(queries), chunk):
            part = [q.to(dev) for q in queries[q0:q0 + chunk]]
            lens = torch.tensor([q.numel() for q in part], device=dev)
            off = torch.zeros(len(part) + 1, dtype=torch.int64, device=dev)
            off[1:] = torch.cumsum(lens, 0)
            v, ok = _kmer_values(torch.cat(part), _window_valid(off, k), k)
            qid = torch.repeat_interleave(torch.arange(len(part), device=dev), lens)
            cnt = torch.zeros((4 ** (k - 1), len(part)), device=dev)
            cnt.index_put_((v[ok], qid[ok]), torch.ones(int(ok.sum()), device=dev),
                           accumulate=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                best = (self._incidence @ cnt).amax(dim=0)
            out.append(best.round().long())
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=dev)


# turn_slv of each orientation the turn check tries: 0 as is, 1
# reversed, 2 complemented, 3 both (the names SINA writes)
TURN_NAMES = ("none", "reversed", "complemented", "reversed and complemented")


def complement(m):
    """Base masks (a uint8 numpy array or torch tensor) complemented: A
    and U (bits 0 and 3) swap, G and C (bits 1 and 2) swap, higher bits
    stay.  The traffic generator turns reads with it too."""
    return ((m & 1) << 3) | ((m & 8) >> 3) | ((m & 2) << 1) | ((m & 4) >> 1) | (m & 0xF0)


def orient(masks: np.ndarray, which: int) -> np.ndarray:
    """A query's masks in orientation `which` (see TURN_NAMES)."""
    out = masks[::-1] if which in (1, 3) else masks
    return complement(out) if which in (2, 3) else out.copy()


def turn_check(kmers: RefKmers, queries: list[np.ndarray], all4: bool) -> list[int]:
    """The orientation of each query: with `all4` (--turn all) as is,
    reversed, complemented and both are tried, else (--turn) as is and
    both; each orientation's top-1 score against every reference, all
    orientations of all queries in one scoring call; a strict `>` in
    that order, so a tie keeps the earlier orientation."""
    tried = (0, 1, 2, 3) if all4 else (0, 3)
    dev = kmers.vals.device
    tops = kmers.top1([torch.from_numpy(orient(q, w)).to(dev) for q in queries
                       for w in tried]).view(len(queries), len(tried)).tolist()
    out = []
    for row in tops:
        best, best_score = 0, 0
        for w, top in zip(tried, row):
            if top > best_score:
                best, best_score = w, top
        out.append(best)
    return out


# the JAX package ranks with its grouped top-k from this many padded
# references on (sina_tpu/famfinder.py:41), a plain top-k below; the
# reference axis pads to a multiple of 1,024 (the bitpacked index)
GROUPED_MIN_WIDTH = 32768
GROUP = 8


def ranking(scores: torch.Tensor, k: int = 256) -> torch.Tensor:
    """Reference ids in the order the famfinder ranks its candidates
    (the JAX package's top-k, sina_tpu/ops/kmer_kernel.py:396-432): by
    score, descending; a plain top-k breaks ties to the lower id; the
    grouped top-k (groups of 8 ids ranked by their best score, ties to
    the lower group) breaks them by the group's rank, then the id.
    (SINA's C++ breaks ties to the higher id.)"""
    n = scores.numel()
    s_pad = -(-max(n, 1) // 1024) * 1024
    C = min(max(k, 256), s_pad // GROUP)
    ids = torch.arange(n, device=scores.device)
    key = scores.to(torch.int64) << 44
    if s_pad >= GROUPED_MIN_WIDTH and 2 * GROUP * C < s_pad:
        padded = torch.zeros(s_pad, dtype=torch.int64, device=scores.device)
        padded[:n] = scores
        gmax = padded.view(-1, GROUP).amax(dim=1)
        key |= gmax[ids // GROUP] << 32
    key |= 0xFFFFFFFF - ids
    return torch.sort(key, descending=True).indices


def select_family(order, scores, lengths, first_pos, last_pos, cfg: dict) -> list[int]:
    """The family of one query (famfinder's policy), as reference ids,
    after the fs_req_gaps filter.  `order` is ranking(scores); lengths,
    first_pos and last_pos are numpy per-reference arrays; `cfg` holds
    fs_min, fs_max, fs_msc, fs_min_len, fs_req_full, fs_full_len,
    fs_cover_gene, gene_start, gene_end, fs_req_gaps."""
    n = len(lengths)
    max_results = cfg["fs_max"] + 1
    while True:
        cand = order[: min(max_results, n)].tolist()
        kept, have, full_n, cl_n, cr_n = [], 0, 0, 0, 0
        for sid in cand:
            ln = int(lengths[sid])
            if ln < cfg["fs_min_len"]:
                continue
            full = ln >= cfg["fs_full_len"]
            cl = ln > 0 and int(first_pos[sid]) <= cfg["gene_start"]
            cr = ln > 0 and int(last_pos[sid]) >= cfg["gene_end"]
            if have >= cfg["fs_min"]:
                score_keeps = float(scores[sid]) < cfg["fs_msc"]
                fills_full = cfg["fs_req_full"] and full_n < cfg["fs_req_full"] and full
                fills_range = cfg["fs_cover_gene"] and (
                    (cr_n < cfg["fs_cover_gene"] and cr) or (cl_n < cfg["fs_cover_gene"] and cl))
                if (have >= cfg["fs_max"] or not score_keeps) and not fills_full \
                        and not fills_range:
                    continue
            have += 1
            full_n += full
            cl_n += cl
            cr_n += cr
            kept.append(sid)
        if (have >= cfg["fs_max"] and full_n >= cfg["fs_req_full"]
                and cl_n >= cfg["fs_cover_gene"] and cr_n >= cfg["fs_cover_gene"]):
            break
        if max_results >= n:
            break
        max_results *= 10
    if cfg["fs_req_gaps"]:
        kept = [s for s in kept if lengths[s]
                and int(last_pos[s]) - int(lengths[s]) + 1 >= cfg["fs_req_gaps"]]
    return kept
