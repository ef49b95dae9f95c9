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
import time
from pathlib import Path

import numpy as np

from . import alphabet, timing
from .sequence import Sequence

FORMAT_VERSION = 1


class ReferenceDb:
    def __init__(
        self,
        sequences: list[Sequence],
        width: int,
        pairs: np.ndarray | None = None,
        astats: list[dict] | None = None,
        path: Path | None = None,
    ):
        self.sequences = sequences
        self.width = int(width)
        self.pairs = (
            pairs if pairs is not None else np.zeros(0, dtype=np.int32)
        )
        # alignment-stats sets: list of dicts with name + column freqs
        self.astats = astats or []
        self.path = path
        self._by_name: dict[str, int] | None = None

    # -- queries ------------------------------------------------------

    def __len__(self) -> int:
        return len(self.sequences)

    @property
    def names(self) -> list[str]:
        return [s.name for s in self.sequences]

    def index_of(self, name: str) -> int:
        if self._by_name is None:
            self._by_name = {
                s.name: i for i, s in enumerate(self.sequences)
            }
        return self._by_name[name]

    def get(self, name: str) -> Sequence:
        return self.sequences[self.index_of(name)]

    def ensure_flat(self) -> None:
        """Stamp every sequence with a `_flat_ref` view into shared
        flat position/mask arrays so batch consumers (profile build)
        gather one big array instead of concatenating thousands of
        small ones.  The stamp carries the positions array object at
        stamp time; consumers verify identity before trusting it."""
        if getattr(self, "_flat_stamped", False):
            return
        n = len(self.sequences)
        lengths = np.array(
            [len(s) for s in self.sequences], dtype=np.int64
        )
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat_pos = (
            np.concatenate(
                [s.positions for s in self.sequences]
            ).astype(np.uint32)
            if n
            else np.zeros(0, np.uint32)
        )
        flat_mask4 = (
            np.concatenate([s.masks for s in self.sequences]) & 0xF
            if n
            else np.zeros(0, np.uint8)
        )
        for i, s in enumerate(self.sequences):
            s._flat_ref = (
                flat_pos,
                flat_mask4,
                int(offsets[i]),
                int(offsets[i + 1]),
                s.positions,
            )
        self._flat = (offsets, flat_pos, flat_mask4)
        self._flat_stamped = True

    def flat_arrays(self):
        """(offsets, flat_positions, flat_mask4) shared batch arrays
        (mask low 4 bits only; built once by ensure_flat)."""
        self.ensure_flat()
        return self._flat

    # -- persistence --------------------------------------------------

    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        n = len(self.sequences)
        lengths = np.array(
            [len(s) for s in self.sequences], dtype=np.int64
        )
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
            "attrs": [
                {k: v for k, v in s.attrs.items()}
                for s in self.sequences
            ],
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
        attrs[i].  How a database built elsewhere, e.g. by the JAX
        package, is carried into this one as numpy arrays."""
        seqs = []
        for i, name in enumerate(names):
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            seqs.append(
                Sequence(
                    name,
                    positions[lo:hi].copy(),
                    masks[lo:hi].copy(),
                    width,
                    dict(attrs[i]),
                )
            )
        return cls(seqs, width, pairs, astats, path)

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
        gather onto device."""
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
