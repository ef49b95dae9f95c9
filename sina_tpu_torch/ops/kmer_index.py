"""Inverted k-mer index as a dense device incidence matrix.

Copy of sina_tpu/ops/kmer_index.py (the CSR postings, their
``index-k{k}{f}.sidx.npz`` cache, readable by both packages, and the
dense, packed and tiled numpy layouts), with the jax placement replaced
by ``device_matrix``, which puts a layout on a torch device: one flat
(R+1, Sb) uint8 bitpacked tensor on every device (the TPU's tiled
layout is scored as its flat view), or the (R+1, S) int8 matrix of
``dense()`` with ``packed=False``.

The reference keeps an inverted index kmer -> compressed id-set and
scores a query by bumping one counter per posting per query k-mer
(SINA src/kmer_search.cpp:152-276,366-420, idset.h:315-337).
Here the formulation is dense: a device-resident incidence matrix
P[kmer_row, seq] in {0,1} and scoring as an embedding-bag gather-sum
S[b,:] = sum_l P[kmer[b,l], :] (see ops/kmer_kernel.py).  "fast" mode
(prefix-A k-mers, kmer_search.cpp:172) quarters the row count.

The index caches to ``<bundle>/index-k{k}{f}.sidx.npz`` (CSR form,
much smaller than dense) with an mtime freshness check, mirroring the
reference's .sidx artefact cache (kmer_search.cpp:213-242).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from .. import timing
from .kmer import kmers_of_masks, BASE_A
from ..refdb import ReferenceDb

logger = logging.getLogger("sina.kmer_index")

SIDX_VERSION = 1


class KmerIndex:
    def __init__(
        self,
        k: int,
        fast: bool,
        n_seqs: int,
        seq_kmers: np.ndarray,
        seq_offsets: np.ndarray,
    ):
        self.k = k
        self.fast = fast
        self.n_seqs = n_seqs
        self.n_rows = 4 ** (k - 1) if fast else 4 ** k
        # CSR: unique k-mers of sequence i are
        # seq_kmers[seq_offsets[i]:seq_offsets[i+1]]
        self.seq_kmers = seq_kmers
        self.seq_offsets = seq_offsets
        self._dense: np.ndarray | None = None

    # -- construction / caching --------------------------------------

    @classmethod
    def from_arrays(cls, seq_kmers, seq_offsets, n_seqs: int, k: int,
                    fast: bool) -> "KmerIndex":
        """An index from its CSR arrays (the cache file's contents):
        how an index built elsewhere, e.g. by the JAX package, is
        carried into this one as numpy arrays."""
        return cls(
            int(k), bool(fast), int(n_seqs),
            np.ascontiguousarray(seq_kmers, np.int32),
            np.ascontiguousarray(seq_offsets, np.int64),
        )

    @classmethod
    def build(cls, db: ReferenceDb, k: int = 10, fast: bool = True):
        """The index of `db`: its .sidx cache, else built (and cached
        beside a bundle)."""
        with timing.span("setup.kmer_index_load", keep=True):
            return cls._load_or_build(db, k, fast)

    @classmethod
    def _load_or_build(cls, db: ReferenceDb, k: int, fast: bool):
        cache = None
        if db.path is not None:
            f = "f" if fast else ""
            cache = Path(db.path) / f"index-k{k}{f}.sidx.npz"
            src = Path(db.path) / "arrays.npz"
            if cache.exists() and src.exists():
                if cache.stat().st_mtime >= src.stat().st_mtime:
                    idx = cls.try_load(cache, k, fast, len(db))
                    if idx is not None:
                        return idx
                else:
                    logger.warning(
                        "Reference %s newer than %s - rebuilding",
                        src, cache,
                    )
        idx = cls._build_from_db(db, k, fast)
        if cache is not None:
            idx.store(cache)
        return idx

    @classmethod
    def _build_from_db(cls, db: ReferenceDb, k: int, fast: bool):
        import time

        t0 = time.time()
        # native multithreaded builder (the reference parallel_reduces
        # this, kmer_search.cpp:152-211); python loop as fallback
        from .. import native

        base_offsets, _, flat_mask4 = db.flat_arrays()
        built = native.build_kmer_lists(
            flat_mask4, base_offsets, k, fast
        )
        if built is not None:
            flat, offsets = built
            logger.info(
                "Built index from %d sequences (%d postings, "
                "native, %.1fs)",
                len(db), len(flat), time.time() - t0,
            )
            return cls(k, fast, len(db), flat, offsets)

        from ..progress import Progress

        prefix = BASE_A if fast else None
        lists = []
        with Progress("Building Index", total=len(db)) as p:
            for s in db.sequences:
                lists.append(
                    kmers_of_masks(
                        s.masks, k, prefix_base=prefix, unique=True
                    ).astype(np.int32)
                )
                p.update()
        offsets = np.zeros(len(lists) + 1, dtype=np.int64)
        np.cumsum([len(v) for v in lists], out=offsets[1:])
        flat = (
            np.concatenate(lists)
            if lists
            else np.zeros(0, dtype=np.int32)
        )
        logger.info(
            "Built index from %d sequences (%d refs)", len(db), len(flat)
        )
        return cls(k, fast, len(db), flat, offsets)

    def store(self, path: Path) -> None:
        np.savez_compressed(
            path,
            version=np.int64(SIDX_VERSION),
            k=np.int64(self.k),
            fast=np.int64(1 if self.fast else 0),
            n_seqs=np.int64(self.n_seqs),
            seq_kmers=self.seq_kmers,
            seq_offsets=self.seq_offsets,
        )

    @classmethod
    def try_load(cls, path: Path, k: int, fast: bool, n_seqs: int):
        try:
            z = np.load(path)
            if (
                int(z["version"]) != SIDX_VERSION
                or int(z["k"]) != k
                or bool(z["fast"]) != fast
                or int(z["n_seqs"]) != n_seqs
            ):
                logger.error(
                    "Index file %s does not match requested "
                    "parameters - rebuilding", path,
                )
                return None
            return cls(
                k, fast, n_seqs, z["seq_kmers"], z["seq_offsets"]
            )
        except Exception as e:  # corrupt cache -> rebuild
            logger.error("Failed to load %s (%s) - rebuilding", path, e)
            return None

    # -- dense representation ----------------------------------------

    def dense(self) -> np.ndarray:
        """(n_rows+1, S_pad) int8 incidence matrix; the extra final
        row stays all-zero as the padding target for invalid k-mers,
        and the sequence axis is padded to a multiple of 128 with
        all-zero columns (so every row is 16-byte aligned)."""
        if self._dense is None:
            s_pad = -(-self.n_seqs // 128) * 128
            P = np.zeros((self.n_rows + 1, s_pad), dtype=np.int8)
            seq_ids = np.repeat(
                np.arange(self.n_seqs, dtype=np.int64),
                np.diff(self.seq_offsets),
            )
            P[self.seq_kmers, seq_ids] = 1
            self._dense = P
        return self._dense

    def dense_packed(self) -> np.ndarray:
        """(n_rows+1, S_pad/8) uint8 bitpacked incidence matrix:
        bit b of byte j = sequence 8j+b present (little bit order).
        8x smaller than dense() in device memory and per-row reads —
        the incidence is {0,1}, the int8 byte per sequence was pure
        padding.  The sequence axis pads to a multiple of 1024.  Built
        straight from the CSR postings; the unpacked matrix is never
        materialised."""
        if getattr(self, "_packed", None) is None:
            from .. import native

            s_pad = -(-max(self.n_seqs, 1) // 1024) * 1024
            P = np.zeros((self.n_rows + 1, s_pad // 8), dtype=np.uint8)
            if not native.fill_packed(
                self.seq_kmers, self.seq_offsets, self.n_seqs, P
            ):
                seq_ids = np.repeat(
                    np.arange(self.n_seqs, dtype=np.int64),
                    np.diff(self.seq_offsets),
                )
                np.bitwise_or.at(
                    P,
                    (self.seq_kmers, seq_ids >> 3),
                    (np.uint8(1) << (seq_ids & 7).astype(np.uint8)),
                )
            self._packed = P
        return self._packed

    def dense_packed_tiled(
        self, byte_multiple: int = 4096
    ) -> np.ndarray:
        """(n_rows+1, 32, W) uint8 row-major view of dense_packed()
        with the byte axis padded to a `byte_multiple` multiple
        (W = Sb4/32; byte_multiple must keep W % 128 == 0, i.e. be a
        multiple of 4096): the TPU's exact-size tiled layout, whose
        logical byte order equals dense_packed()'s."""
        if byte_multiple % 4096:
            raise ValueError(
                f"byte_multiple must be a multiple of 4096 "
                f"(got {byte_multiple})"
            )
        P = self.dense_packed()
        Sb = P.shape[1]
        m = byte_multiple
        Sb4 = -(-max(Sb, m) // m) * m
        if Sb4 != Sb:
            P = np.pad(P, ((0, 0), (0, Sb4 - Sb)))
        return np.ascontiguousarray(P).reshape(
            P.shape[0], 32, Sb4 // 32
        )


def device_matrix(index: KmerIndex | np.ndarray, device: torch.device,
                  packed: bool = True) -> torch.Tensor:
    """The incidence matrix on `device` (counterpart of
    sina_tpu/ops/kmer_index.py KmerIndex.device_matrix).  Bitpacked by
    default: the (R+1, Sb) uint8 matrix of a KmerIndex (its
    dense_packed()) or a numpy one, flat (R+1, Sb) or tiled
    (R+1, 32, W) — the same bytes in the same order, so the tiled form
    becomes its (R+1, 32*W) view.  With packed=False, a KmerIndex's
    (R+1, S) int8 dense(), which kmer_kernel's dispatch sends to the
    dense scorer."""
    if isinstance(index, KmerIndex) and not packed:
        return torch.from_numpy(index.dense()).to(device)
    arr = index.dense_packed() if isinstance(index, KmerIndex) else index
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
        raise ValueError(
            f"expected a packed uint8 (R, Sb) or (R, 32, W) matrix, "
            f"got {arr.dtype} {arr.shape}"
        )
    arr = np.ascontiguousarray(arr).reshape(arr.shape[0], -1)
    return torch.from_numpy(arr).to(device)
