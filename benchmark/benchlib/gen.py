"""Synthetic SILVA-like reference and query traffic, made on the device.

A vectorised rewrite, in PyTorch, of the port's Python-loop generators
(frozen from sina_tpu_torch/testing.py:164 ``make_reference_large`` and
:428 ``make_queries``; ``amplicon_cut`` from bench_torch.py:104).  The
laws are the same; the draws are torch's, so the numbers differ from
the originals':

- reference: a root over ``n_core`` columns of a ``width``-column
  alignment, one ancestor per genus of ``group`` references
  (substitutions at 0.10 x rate, knock-outs at 0.01 x rate), leaves
  with substitutions at 0.03 x rate, deletions at 0.004 x rate and a
  Poisson(2) number of insertions into columns no core base uses;
  rates are 3.0 for a quarter of the columns, else 0.35;
- queries: one more branch off a parent reference (``branch_len``):
  substitutions at 0.06 x bl x rate, deletions at 0.004 x bl x rate,
  and insertions into empty columns, a Poisson(0.003 x bl x empty)
  number of them at uniform columns (a draw that hits an occupied
  column or repeats one is dropped: about 3% of them);
- amplicons: the 250 bases from min(400, (len - 250) // 2).

Every draw comes from one ``torch.Generator`` on the device, seeded by
the caller, in a fixed order and in fixed chunks, so the same seed on
the same kind of device gives the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# base masks in the port's alphabet order A G C U (bits 0-3)
BASE_MASKS = (1, 2, 4, 8)
_TAX_LEVELS = ("Dom", "Phy", "Cls", "Ord", "Fam", "Gen")
# ancestors generated together (the chunking is part of the law: the
# draws of one chunk follow the previous chunk's)
ANC_CHUNK = 1024


@dataclass
class RefArrays:
    """A reference alignment as flat arrays on one device: reference i
    holds positions/masks[offsets[i]:offsets[i + 1]] (ascending
    columns)."""

    positions: torch.Tensor  # (E,) int32 alignment columns
    masks: torch.Tensor      # (E,) uint8 base masks
    offsets: torch.Tensor    # (n + 1,) int64
    width: int
    group: int

    @property
    def n(self) -> int:
        return self.offsets.numel() - 1

    def lengths(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def _bases(g, n: int, device) -> torch.Tensor:
    lut = torch.tensor(BASE_MASKS, dtype=torch.uint8, device=device)
    return lut[torch.randint(0, 4, (n,), generator=g, device=device)]


def _rates(g, n: int, device) -> torch.Tensor:
    u = torch.rand(n, generator=g, device=device)
    return torch.where(u < 0.25, 3.0, 0.35)


def make_reference(n_refs: int, n_core: int, width: int, group: int, seed: int,
                   device) -> RefArrays:
    """The reference alignment (make_reference_large's law)."""
    g = _gen(seed, device)
    nc = min(n_core, width)
    core = torch.randperm(width, generator=g, device=device)[:nc].sort().values
    is_core = torch.zeros(width, dtype=torch.bool, device=device)
    is_core[core] = True
    empty = torch.nonzero(~is_core).flatten()
    root = _bases(g, nc, device)
    rates = _rates(g, nc, device)
    n_anc = -(-n_refs // group)
    sub = torch.rand((n_anc, nc), generator=g, device=device) < (0.10 * rates).clamp(0, 0.6)
    anc = root.expand(n_anc, nc).clone()
    anc[sub] = _bases(g, int(sub.sum()), device)
    anc_keep = torch.rand((n_anc, nc), generator=g, device=device) > 0.01 * rates

    pos_parts, mask_parts, len_parts = [], [], []
    for a0 in range(0, n_anc, ANC_CHUNK):
        a1 = min(n_anc, a0 + ANC_CHUNK)
        r0, r1 = a0 * group, min(n_refs, a1 * group)
        L = r1 - r0
        leaf_anc = torch.arange(r0, r1, device=device) // group
        bases = anc[leaf_anc]
        sub = torch.rand((L, nc), generator=g, device=device) < (0.03 * rates).clamp(0, 0.5)
        bases[sub] = _bases(g, int(sub.sum()), device)
        keep = anc_keep[leaf_anc] & (torch.rand((L, nc), generator=g, device=device)
                                     > 0.004 * rates)
        n_ins = torch.poisson(torch.full((L,), 2.0, device=device), generator=g).long()
        tot = int(n_ins.sum())
        ins_leaf = torch.repeat_interleave(torch.arange(L, device=device), n_ins)
        ins_col = empty[torch.randint(0, empty.numel(), (tot,), generator=g, device=device)]
        ins_base = _bases(g, tot, device)
        # one base per (leaf, column): a repeated insertion column keeps
        # its first draw
        ikey = ins_leaf * width + ins_col
        ikey, first = _first_of_each(ikey)
        ins_base = ins_base[first]
        leaf, ci = torch.nonzero(keep, as_tuple=True)
        ckey = leaf * width + core[ci]
        key = torch.cat([ckey, ikey])
        msk = torch.cat([bases[leaf, ci], ins_base])
        key, order = key.sort()
        pos_parts.append((key % width).to(torch.int32))
        mask_parts.append(msk[order])
        len_parts.append(torch.bincount(key // width, minlength=L))
        del bases, sub, keep
    lengths = torch.cat(len_parts)
    offsets = torch.zeros(n_refs + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(lengths, 0)
    return RefArrays(torch.cat(pos_parts), torch.cat(mask_parts), offsets, width, group)


def _first_of_each(key: torch.Tensor):
    """(the distinct keys ascending, the index of each one's first
    occurrence in `key`)."""
    if key.numel() == 0:
        return key, torch.zeros(0, dtype=torch.int64, device=key.device)
    skey, order = torch.sort(key, stable=True)
    head = torch.ones_like(skey, dtype=torch.bool)
    head[1:] = skey[1:] != skey[:-1]
    return skey[head], order[head]


def ref_attrs(n_refs: int, group: int) -> tuple[list[str], list[dict]]:
    """Names and metadata of the references, as make_reference_large
    writes them (taxonomy from the genus index's bits)."""
    names, attrs = [], []
    for i in range(n_refs):
        a = i // group
        acc, labels = 0, []
        for lvl, name in enumerate(_TAX_LEVELS):
            acc = acc * 2 + ((a >> (len(_TAX_LEVELS) - 1 - lvl)) & 1)
            labels.append(f"{name}{acc}")
        names.append(f"SEQ{i:06d}")
        attrs.append({"tax_slv": ";".join(labels) + ";", "acc": f"ACC{i:06d}",
                      "start": "1", "version": "1"})
    return names, attrs


@dataclass
class Queries:
    """Unaligned queries as flat base masks: query i is
    masks[offsets[i]:offsets[i + 1]]; parents[i] its parent reference."""

    masks: torch.Tensor    # (E,) uint8
    offsets: torch.Tensor  # (n + 1,) int64
    parents: torch.Tensor  # (n,) int64

    @property
    def n(self) -> int:
        return self.offsets.numel() - 1


def make_queries(ref: RefArrays, n: int, seed: int, branch_len: float, parents: str,
                 amplicon: dict | None, device) -> Queries:
    """`n` queries evolved off parents drawn from `ref` (make_queries'
    law), cut to amplicons when `amplicon` gives {"length", "max_start"}.
    `parents` is "uniform": every reference is equally likely."""
    g = _gen(seed, device)
    width = ref.width
    rates_w = _rates(g, width, device)
    if parents != "uniform":
        raise ValueError(f"unknown law of parents: {parents!r}")
    par = torch.randint(0, ref.n, (n,), generator=g, device=device)
    lens = ref.lengths()[par]
    qid = torch.repeat_interleave(torch.arange(n, device=device), lens)
    start = torch.zeros(n + 1, dtype=torch.int64, device=device)
    start[1:] = torch.cumsum(lens, 0)
    idx = ref.offsets[par][qid] + torch.arange(qid.numel(), device=device) - start[qid]
    pos = ref.positions[idx].long()
    msk = ref.masks[idx].clone()
    r = rates_w[pos]
    E = pos.numel()
    sub = torch.rand(E, generator=g, device=device) < (0.06 * branch_len * r).clamp(0, 0.75)
    msk[sub] = _bases(g, int(sub.sum()), device)
    keep = torch.rand(E, generator=g, device=device) >= 0.004 * branch_len * r
    qid, pos, msk = qid[keep], pos[keep], msk[keep]
    kept = torch.bincount(qid, minlength=n)
    lam = (0.003 * branch_len * (width - kept)).double()
    n_ins = torch.poisson(lam, generator=g).long()
    tot = int(n_ins.sum())
    ins_q = torch.repeat_interleave(torch.arange(n, device=device), n_ins)
    ins_col = torch.randint(0, width, (tot,), generator=g, device=device)
    ins_base = _bases(g, tot, device)
    okey = qid * width + pos  # ascending: queries in order, columns ascending
    ikey = ins_q * width + ins_col
    ikey, first = _first_of_each(ikey)
    ins_base = ins_base[first]
    at = torch.searchsorted(okey, ikey).clamp(max=max(okey.numel() - 1, 0))
    free = (okey[at] != ikey) if okey.numel() else torch.ones_like(ikey, dtype=torch.bool)
    key = torch.cat([okey, ikey[free]])
    allm = torch.cat([msk, ins_base[free]])
    key, order = key.sort()
    allm = allm[order]
    q = key // width
    qlen = torch.bincount(q, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(qlen, 0)
    if amplicon is not None:
        L, max_start = int(amplicon["length"]), int(amplicon["max_start"])
        lo = torch.clamp((qlen - L).clamp(min=0) // 2, max=max_start)
        alen = torch.minimum(qlen, torch.full_like(qlen, L))
        aq = torch.repeat_interleave(torch.arange(n, device=device), alen)
        astart = torch.zeros(n + 1, dtype=torch.int64, device=device)
        astart[1:] = torch.cumsum(alen, 0)
        within = torch.arange(aq.numel(), device=device) - astart[aq]
        allm = allm[offsets[aq] + lo[aq] + within]
        offsets = astart
    return Queries(allm, offsets, par)


_CHARS = np.zeros(256, dtype=np.uint8)
for _m, _c in zip(BASE_MASKS, b"AGCU"):
    _CHARS[_m] = _c
NAME_DIGITS = 8


def record_name(i: int) -> str:
    return f"q{i:0{NAME_DIGITS}d}"


def to_fasta(q: Queries) -> tuple[bytes, np.ndarray]:
    """The queries as one FASTA byte string, ">q%08d\\n<bases>\\n" a
    record, and the (n + 1,) byte offsets of the records."""
    masks = q.masks.cpu().numpy()
    offs = q.offsets.cpu().numpy()
    n = len(offs) - 1
    lens = np.diff(offs)
    hdr = 2 + NAME_DIGITS  # '>' 'q' digits, then '\n'
    rec = hdr + 1 + lens + 1
    roff = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rec, out=roff[1:])
    out = np.empty(int(roff[-1]), dtype=np.uint8)
    i = np.arange(n, dtype=np.int64)
    out[roff[:-1]] = ord(">")
    out[roff[:-1] + 1] = ord("q")
    for d in range(NAME_DIGITS):
        out[roff[:-1] + 2 + d] = ord("0") + (i // 10 ** (NAME_DIGITS - 1 - d)) % 10
    out[roff[:-1] + hdr] = ord("\n")
    out[roff[1:] - 1] = ord("\n")
    qid = np.repeat(i, lens)
    dst = roff[:-1][qid] + hdr + 1 + (np.arange(len(masks)) - offs[:-1][qid])
    out[dst] = _CHARS[masks]
    return out.tobytes(), roff
