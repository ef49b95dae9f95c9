"""CSV output writer (semantics of SINA src/rw_csv.cpp:50-208).

Writes one row per sequence: an id column plus attribute columns.  The
column set is either the explicit field list or the attributes of the
first sequence written.  RFC4180 escaping; separator ',' or TAB chosen
by file extension (.tsv); optional CRLF line endings; .gz supported.
"""

from __future__ import annotations

import gzip
import sys
from pathlib import Path

from ..sequence import Sequence
from .fasta import _fmt_value


class CsvWriter:
    def __init__(
        self,
        path,
        fields: list[str] | None = None,
        crlf: bool = False,
        id_name: str = "name",
        sep: str = "",
    ):
        p = str(path)
        self._close = p != "-"
        stem = Path(p)
        if stem.suffix == ".gz":
            self.fh = gzip.open(stem, "wt")
            stem = stem.with_suffix("")
        elif p == "-":
            self.fh = sys.stdout
        else:
            self.fh = open(p, "w")
        # --csv-sep overrides; default ',' or TAB for .tsv
        # (rw_csv.cpp:62-66)
        self.sep = sep or ("\t" if stem.suffix == ".tsv" else ",")
        self.eol = "\r\n" if crlf else "\n"
        self.fields = list(fields) if fields else None
        self.id_name = id_name
        self.count = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._close:
            self.fh.close()

    def _esc(self, s: str) -> str:
        if not any(c in s for c in self.sep + '"\r\n'):
            return s
        return '"' + s.replace('"', '""') + '"'

    def write(self, seq: Sequence | None) -> None:
        if seq is None:
            return
        if self.fields is None:
            self.fields = [k for k in seq.attrs]
        if self.count == 0:
            self.fh.write(
                self.sep.join(
                    [self._esc(self.id_name)]
                    + [self._esc(f) for f in self.fields]
                )
                + self.eol
            )
        row = [self._esc(seq.name)]
        for f in self.fields:
            v = seq.attrs.get(f, "")
            row.append(self._esc(_fmt_value(v)) if v != "" else "")
        self.fh.write(self.sep.join(row) + self.eol)
        self.count += 1
