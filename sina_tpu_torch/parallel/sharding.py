"""Multi-device sharding of the k-mer search index and query batches.

Port of sina_tpu/parallel/sharding.py.  The k-mer incidence matrix is
split over the reference-sequence axis ("mp"), query batches are
data-parallel over "dp", and each dp row merges its shards' top-k
candidates.  The JAX package states this with shard_map specs and lets
XLA place the shards and insert the all-gather; here every shard is a
tensor of its own on its device, scored by the single-device scorer of
ops/kmer_kernel (csrc/kmer_score.cu on the card, once per shard; its
plain version on the CPU), and the shards' candidates are gathered on
the dp row's first device.  A mesh may name one device more than once:
its shards are then separate tensors and separate launches there.

Above 32k references famfinder ships the index in the exact-size tiled
(R, 32, W) layout sharded over its lanes: shard s holds lanes
[s*Wl, (s+1)*Wl) of every one of the 32 sublane rows, which is itself
a tiled matrix, scored as its flat (R, 32*Wl) view.  So a shard's
references are not a contiguous id range.

Tie order.  The merge keeps jax.lax.top_k's rule over the gathered
(B, mp*k) array: equal values go to the lowest flattened position,
shard-major, not to the lowest global id.  On a flat layout with
fewer than 32,768 references a shard, whose shards are contiguous id
ranges ranked lowest id first, the two agree.  On the tiled layout
they need not, nor where a shard ranks with the grouped top-k: there
the merged ids on a tie can differ from one device's score_topk, as
the JAX package's do.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import transfer
from ..ops.kmer_kernel import (
    GROUPED_MIN_WIDTH, grouped_top_k, kmer_scores, top_k_lowest_id,
)
from .multihost import process_count, process_index

logger = logging.getLogger("sina.sharding")


class Mesh:
    """A (dp, mp) grid of torch devices.  ``devices`` holds the dp rows
    this process serves (``rows`` gives their indices): every row in
    one process, its own row when dp spans the processes of a group."""

    def __init__(self, devices, dp: int, rows):
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in devices)
        self.shape = {"dp": dp, "mp": len(self.devices[0])}
        self.rows = tuple(rows)

    @property
    def spans_processes(self) -> bool:
        return len(self.rows) < self.shape["dp"]


def make_mesh(devices=None, dp: int | None = None) -> Mesh:
    """Build a (dp, mp) mesh over the given devices (by default every
    visible CUDA device), rule for rule as sina_tpu/parallel/sharding.py
    make_mesh.

    An explicitly requested dp that does not divide the device count
    raises (no silent config-swallowing); the mesh is then this
    process's alone.  Otherwise, with more than one process in the
    group (parallel.multihost.initialize), dp is the process count:
    "dp" spans the processes, each holding one row whose devices are
    its index ("mp") shards.  In one process dp is 2 for an even count
    of at least 4 devices, else 1, and an odd count >= 3 is logged
    loudly."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh needs at least one device")
    if dp is not None:
        if dp < 1 or n % dp != 0:
            raise ValueError(
                f"requested dp={dp} does not divide the {n}-device mesh"
            )
    elif process_count() > 1:
        return Mesh([devices], process_count(), [process_index()])
    else:
        dp = 2 if n % 2 == 0 and n >= 4 else 1
        if dp == 1 and n >= 3:
            logger.warning(
                "make_mesh: %d devices is odd — using a (1, %d) "
                "mesh (no data-parallel axis); pass dp= "
                "explicitly to override", n, n,
            )
    mp = n // dp
    return Mesh([devices[r * mp:(r + 1) * mp] for r in range(dp)], dp, range(dp))


@dataclass
class ShardedMatrix:
    """An incidence matrix split over a mesh's "mp" axis.  ``shape``
    and ``dtype`` are the whole matrix's: tiled (R, 32, W) uint8, flat
    (R, Sb) uint8 bitpacked or (R, S) int8 dense.  ``shards[r][s]`` is
    shard s of the r-th dp row this process serves, on that row's
    device s: a tiled matrix's lanes [s*Wl, (s+1)*Wl) as a contiguous
    (R, 32*Wl) tensor, a flat one's columns [s*w, (s+1)*w).  Every dp
    row holds a replica; a device that serves a shard twice holds it
    once."""

    shape: tuple
    dtype: torch.dtype
    shards: list

    @property
    def tiled(self) -> bool:
        return len(self.shape) == 3


def place_shards(mesh: Mesh, shape, dtype: torch.dtype, make) -> ShardedMatrix:
    """A ShardedMatrix whose shard s on device d is make(s, d), made
    once for each (s, d) the mesh names."""
    placed: dict = {}
    shards = []
    for row in mesh.devices:
        for s, dev in enumerate(row):
            if (s, dev) not in placed:
                placed[(s, dev)] = make(s, dev)
        shards.append([placed[(s, dev)] for s, dev in enumerate(row)])
    return ShardedMatrix(tuple(shape), dtype, shards)


def shard_index_matrix(mesh: Mesh, P: np.ndarray) -> ShardedMatrix:
    """Place the host incidence matrix P sharded over "mp": the tiled
    (R, 32, W) layout over lanes (its last axis), the flat (R, Sb)
    layouts over the sequence/byte axis.  Each shard is sliced on the
    host and copied straight to its device: the whole matrix never
    sits on one device (14.7 GB at 450k references)."""
    P = np.asarray(P)
    mp = mesh.shape["mp"]
    if P.ndim not in (2, 3) or P.shape[-1] % mp:
        raise ValueError(f"cannot split a {P.shape} matrix over mp={mp}")
    w = P.shape[-1] // mp

    def make(s, dev):
        block = np.ascontiguousarray(P[..., s * w:(s + 1) * w])
        return torch.from_numpy(block.reshape(P.shape[0], -1)).to(dev)

    return place_shards(mesh, P.shape, torch.from_numpy(P[:0]).dtype, make)


def _row_batches(mesh: Mesh, kmers):
    """For each dp row this process serves: its slice of the batch
    (B/dp rows; B must split evenly) on each of the row's devices."""
    if not isinstance(kmers, torch.Tensor):
        kmers = np.ascontiguousarray(kmers, dtype=np.int32)
    dp = mesh.shape["dp"]
    if kmers.shape[0] % dp:
        raise ValueError(f"a batch of {kmers.shape[0]} does not split over dp={dp}")
    b = kmers.shape[0] // dp
    out = []
    for r, devs in zip(mesh.rows, mesh.devices):
        part = kmers[r * b:(r + 1) * b]
        # host ids go up through pinned staging (ops/transfer), without
        # blocking the host
        on = {dev: part.to(dev, torch.int32) if isinstance(part, torch.Tensor)
              else transfer.upload(part, dev) for dev in dict.fromkeys(devs)}
        out.append([on[dev] for dev in devs])
    return out


def _join_rows(mesh: Mesh, parts: list) -> torch.Tensor:
    """The dp rows' results as one batch: on the mesh's first device,
    or, when dp spans processes, all-gathered over the group as host
    tensors (gloo has no CUDA all_gather), so that every process
    returns the whole batch."""
    if mesh.spans_processes:
        import torch.distributed as dist

        mine = torch.cat([p.cpu() for p in parts]).contiguous()
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        return torch.cat(every)
    dev0 = mesh.devices[0][0]
    return torch.cat([p.to(dev0) for p in parts])


def _shard_top_k(P: ShardedMatrix, shard: torch.Tensor, s: int, kmers, k_top: int,
                 mp: int):
    """Shard s's top min(k_top, its width) scores and their global ids
    (int64), as sina_tpu/parallel/sharding.py fn_tiled / fn_flat."""
    if P.tiled:
        span = 8 * (P.shape[2] // mp)  # a sublane row's references in a shard
        scores, gmax = kmer_scores(shard, kmers, gmax=True)
        v, i = grouped_top_k(scores, min(k_top, 32 * span), gmax)
        # local (sub*Wl + lane)*8 + bit -> global (sub*W + s*Wl + lane)*8 + bit
        i = i.long()
        return v, (i // span * mp + s) * span + i % span
    s_local = shard.shape[1] * (8 if P.dtype == torch.uint8 else 1)
    k_local = min(k_top, s_local)
    if s_local >= GROUPED_MIN_WIDTH:
        if P.dtype == torch.uint8:
            scores, gmax = kmer_scores(shard, kmers, gmax=True)
        else:
            scores, gmax = kmer_scores(shard, kmers), None
        v, i = grouped_top_k(scores, k_local, gmax)
    else:
        v, i = top_k_lowest_id(kmer_scores(shard, kmers), k_local)
    return v, i.long() + s * s_local


def _merge(cands: list, k_top: int, dev: torch.device):
    """Merge a dp row's per-shard candidates on `dev`: the shards'
    (b, k) lists side by side, shard-major, then the top k_top of the
    (b, mp*k) array, equal values to the lowest position (lax.top_k's
    order), padded to k_top with -1 / 0 where mp*k < k_top."""
    v = torch.stack([v.to(dev) for v, _ in cands], 1)
    i = torch.stack([i.to(dev) for _, i in cands], 1)
    b = v.shape[0]
    v, i = v.reshape(b, -1), i.reshape(b, -1)
    k_out = min(k_top, v.shape[1])
    vbest, sel = top_k_lowest_id(v, k_out)
    ibest = torch.gather(i, 1, sel.long()).to(torch.int32)
    if k_out < k_top:
        vbest = torch.nn.functional.pad(vbest, (0, k_top - k_out), value=-1)
        ibest = torch.nn.functional.pad(ibest, (0, k_top - k_out), value=0)
    return vbest, ibest


def sharded_search(mesh: Mesh, k_top: int):
    """Sharded scoring + top-k: returns fn(P, kmers) -> (vals, ids),
    both (B, k_top) int32, for P a ShardedMatrix of this mesh and
    kmers (B, L) int32 (numpy or a tensor; B a multiple of dp, the
    caller pads with the sink row).  Each shard's top-k: the grouped
    top-k on the tiled layout always, on a flat one from 32,768
    references a shard, else the lowest-id top-k; then the dp row's
    merge.  Every shard is launched before any result is fetched, so
    the launches queue on their devices and overlap."""
    mp = mesh.shape["mp"]

    def fn(P: ShardedMatrix, kmers):
        cands = [
            [_shard_top_k(P, shard, s, km, k_top, mp)
             for s, (shard, km) in enumerate(zip(shards, kms))]
            for shards, kms in zip(P.shards, _row_batches(mesh, kmers))
        ]
        merged = [_merge(c, k_top, devs[0]) for c, devs in zip(cands, mesh.devices)]
        return (_join_rows(mesh, [v for v, _ in merged]),
                _join_rows(mesh, [i for _, i in merged]))

    return fn


def sharded_scores(mesh: Mesh, P: ShardedMatrix, kmers) -> torch.Tensor:
    """Raw scores (B, S) int32 in the whole matrix's reference order,
    what one device's kmer_scores gives on the unsplit matrix (the JAX
    package's kmer_scores on its sharded array): a tiled matrix's
    shards interleave by sublane row, a flat one's follow each other."""
    rows = []
    for shards, kms in zip(P.shards, _row_batches(mesh, kmers)):
        dev = shards[0].device
        parts = [kmer_scores(shard, km).to(dev) for shard, km in zip(shards, kms)]
        if P.tiled:
            b = parts[0].shape[0]
            rows.append(torch.cat([p.view(b, 32, -1) for p in parts], 2).reshape(b, -1))
        else:
            rows.append(torch.cat(parts, 1))
    return _join_rows(mesh, rows)
