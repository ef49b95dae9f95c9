"""Reference database bundle — the ARB-file replacement.

The reference keeps its alignment reference in an ARB container
(SINA src/query_arb.{h,cpp}); functionally what the pipeline
needs is: named aligned sequences, per-sequence metadata fields,
per-column statistics (for the weighted scoring scheme), and a helix
pairing vector.  We store exactly that as a ``.sref`` directory:

  arrays.npz   flat base positions/masks + offsets, column stats, pairs
  meta.json    names, alignment width, per-sequence attributes

Bundles are built from an aligned FASTA (the reference's
``--prealigned`` trick, doc/source/commandline.rst:83-85) plus an
optional CSV of metadata.
"""

from __future__ import annotations

import json
import operator
from collections.abc import Sequence as _SequenceABC
from pathlib import Path

import numpy as np

from . import timing
from .sequence import Sequence

FORMAT_VERSION = 1


def _readonly(a: np.ndarray) -> np.ndarray:
    """A read-only view of `a` (`a` itself stays writable)."""
    v = a.view()
    v.flags.writeable = False
    return v


class FlatSequences(_SequenceABC):
    """A bundle's references kept as its flat arrays: reference i is
    positions/masks[offsets[i]:offsets[i+1]] with attrs[i].  Indexing
    makes reference i's `Sequence` the first time it is asked for, of
    read-only views into the arrays and stamped with its `_flat_ref`,
    and keeps it (counted as ``refdb.materialized``); a slice is a list
    of them.  The length, the names and `flat()` make none."""

    def __init__(self, names, offsets, positions, masks, width, attrs):
        self.names = list(names)
        self.offsets = _readonly(np.ascontiguousarray(offsets, np.int64))
        self.positions = _readonly(np.ascontiguousarray(positions, np.uint32))
        self.masks = _readonly(np.ascontiguousarray(masks, np.uint8))
        self.width = int(width)
        self._attrs = list(attrs)
        self._made: list[Sequence | None] = [None] * len(self.names)
        self._mask4: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._get(k) for k in range(*i.indices(len(self)))]
        i = operator.index(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(f"reference {i} out of range")
        return self._get(i)

    def __iter__(self):
        return map(self._get, range(len(self)))

    def _get(self, i: int) -> Sequence:
        s = self._made[i]
        if s is None:
            lo, hi = self.offsets.item(i), self.offsets.item(i + 1)
            pos = self.positions[lo:hi]
            s = Sequence(self.names[i], pos, self.masks[lo:hi], self.width,
                         dict(self._attrs[i]))
            s._flat_ref = (self.positions, self.flat()[2], lo, hi, pos)
            self._made[i] = s
            timing.count("refdb.materialized")
        return s

    def attrs(self) -> list[dict]:
        """Every reference's attributes (a made reference's own dict)."""
        return [a if s is None else s.attrs
                for s, a in zip(self._made, self._attrs)]

    def flat(self):
        """(offsets, positions, mask4): the store itself, with the masks'
        low 4 bits (the masks themselves where no higher bit is set)."""
        if self._mask4 is None:
            m = self.masks
            self._mask4 = (m if m.size == 0 or m.max() <= 0xF
                           else _readonly(m & 0xF))
        return self.offsets, self.positions, self._mask4


class ReferenceDb:
    def __init__(
        self,
        sequences: list[Sequence] | FlatSequences,
        width: int,
        pairs: np.ndarray | None = None,
        astats: list[dict] | None = None,
        path: Path | None = None,
    ):
        """`sequences`: a list of `Sequence`s, or a bundle's arrays as
        `FlatSequences` (`from_arrays`, `load`)."""
        self.sequences = sequences
        self.width = int(width)
        self.pairs = (
            pairs if pairs is not None else np.zeros(0, dtype=np.int32)
        )
        # alignment-stats sets: list of dicts with name + column freqs
        self.astats = astats or []
        self.path = path
        self._by_name: dict[str, int] | None = None
        self._flat = None

    # -- queries ------------------------------------------------------

    def __len__(self) -> int:
        return len(self.sequences)

    @property
    def names(self) -> list[str]:
        if isinstance(self.sequences, FlatSequences):
            return list(self.sequences.names)
        return [s.name for s in self.sequences]

    def index_of(self, name: str) -> int:
        if self._by_name is None:
            self._by_name = {n: i for i, n in enumerate(self.names)}
        return self._by_name[name]

    def get(self, name: str) -> Sequence:
        return self.sequences[self.index_of(name)]

    def ensure_flat(self) -> None:
        """Make `flat_arrays()`: shared flat position/mask arrays that
        batch consumers (profile build) gather from instead of
        concatenating thousands of small ones.  A sequence reaches them
        through its `_flat_ref` stamp (flat positions, flat mask4,
        start, end, its positions array at stamp time); consumers
        verify that array's identity before trusting the stamp.  A
        bundle's store is those arrays already and stamps each sequence
        as it is made; a list of sequences is concatenated and every
        one stamped here."""
        if self._flat is not None:
            return
        with timing.span("setup.refdb_flat", keep=True):
            if isinstance(self.sequences, FlatSequences):
                self._flat = self.sequences.flat()
                return
            offsets, flat_pos, flat_masks = self.packed_arrays()
            flat_pos = flat_pos.astype(np.uint32, copy=False)
            flat_mask4 = flat_masks & 0xF
            for i, s in enumerate(self.sequences):
                s._flat_ref = (
                    flat_pos,
                    flat_mask4,
                    int(offsets[i]),
                    int(offsets[i + 1]),
                    s.positions,
                )
            self._flat = (offsets, flat_pos, flat_mask4)

    def flat_arrays(self):
        """(offsets, flat_positions, flat_mask4) shared batch arrays
        (mask low 4 bits only; made once by ensure_flat)."""
        self.ensure_flat()
        return self._flat

    # -- persistence --------------------------------------------------

    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        offsets, flat_pos, flat_masks = self.packed_arrays()
        astat_arrays = {}
        astat_meta = []
        for i, a in enumerate(self.astats):
            astat_meta.append({"name": a["name"], "ntaxa": a["ntaxa"]})
            astat_arrays[f"astat_{i}_freqs"] = a["freqs"]
        np.savez_compressed(
            path / "arrays.npz",
            offsets=offsets,
            positions=flat_pos,
            masks=flat_masks,
            pairs=self.pairs,
            **astat_arrays,
        )
        meta = {
            "format_version": FORMAT_VERSION,
            "width": self.width,
            "names": self.names,
            "attrs": (
                self.sequences.attrs()
                if isinstance(self.sequences, FlatSequences)
                else [s.attrs for s in self.sequences]
            ),
            "astats": astat_meta,
        }
        (path / "meta.json").write_text(json.dumps(meta))
        self.path = path

    @classmethod
    def load(cls, path) -> "ReferenceDb":
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"{path}: unsupported bundle version "
                f"{meta['format_version']}"
            )
        arr = np.load(path / "arrays.npz")
        astats = []
        for i, am in enumerate(meta.get("astats", [])):
            astats.append(
                {
                    "name": am["name"],
                    "ntaxa": am["ntaxa"],
                    "freqs": arr[f"astat_{i}_freqs"],
                }
            )
        return cls.from_arrays(
            meta["names"], arr["offsets"], arr["positions"], arr["masks"],
            meta["width"], meta["attrs"], arr["pairs"], astats, path,
        )

    @classmethod
    def from_arrays(
        cls, names, offsets, positions, masks, width, attrs,
        pairs=None, astats=None, path=None,
    ) -> "ReferenceDb":
        """A database from the bundle's own arrays: sequence i is
        positions/masks[offsets[i]:offsets[i+1]] with attributes
        attrs[i], kept as those arrays (`FlatSequences`: a sequence is
        made only when asked for, of read-only views).  How a database
        built elsewhere, e.g. by the JAX package, is carried into this
        one as numpy arrays."""
        return cls(
            FlatSequences(names, offsets, positions, masks, width, attrs),
            width, pairs, astats, path,
        )

    @classmethod
    def open(cls, path) -> "ReferenceDb":
        """Open a bundle directory, or build one from an aligned FASTA
        (cached next to the input, mtime-validated like the reference's
        .sidx cache, kmer_search.cpp:226-242)."""
        path = Path(path)
        with timing.span("setup.refdb_open", keep=True):
            if path.is_dir() and (path / "meta.json").exists():
                return cls.load(path)
            if path.suffix in (".fasta", ".fa", ".gz") or path.is_file():
                bundle = path.with_suffix(path.suffix + ".sref")
                if bundle.is_dir() and (bundle / "meta.json").exists():
                    if bundle.stat().st_mtime >= path.stat().st_mtime:
                        return cls.load(bundle)
                db = cls.from_fasta(path)
                db.save(bundle)
                return db
        raise FileNotFoundError(f"Reference database {path} not found")

    # -- construction -------------------------------------------------

    @classmethod
    def from_fasta(cls, path, metadata_csv=None) -> "ReferenceDb":
        from .io.fasta import read_fasta

        seqs = list(read_fasta(path))
        if not seqs:
            raise ValueError(f"No sequences in {path}")
        width = max(s.width for s in seqs)
        for s in seqs:
            s.set_width(width)
        if metadata_csv is not None:
            import csv as _csv

            with open(metadata_csv) as fh:
                rd = _csv.DictReader(fh)
                by_name = {}
                for row in rd:
                    key = row.get("name") or next(iter(row.values()))
                    by_name[key] = row
            for s in seqs:
                if s.name in by_name:
                    s.attrs.update(
                        {
                            k: v
                            for k, v in by_name[s.name].items()
                            if k != "name"
                        }
                    )
        return cls(seqs, width)

    # -- helpers for device-side batching -----------------------------

    def packed_arrays(self):
        """(offsets, flat_positions, flat_masks) int arrays for batch
        gather onto device (a bundle's store itself)."""
        if isinstance(self.sequences, FlatSequences):
            st = self.sequences
            return st.offsets, st.positions, st.masks
        n = len(self.sequences)
        lengths = np.array([len(s) for s in self.sequences], np.int64)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat_pos = (
            np.concatenate([s.positions for s in self.sequences])
            if n
            else np.zeros(0, np.uint32)
        )
        flat_masks = (
            np.concatenate([s.masks for s in self.sequences])
            if n
            else np.zeros(0, np.uint8)
        )
        return offsets, flat_pos, flat_masks
