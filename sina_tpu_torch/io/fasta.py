"""FASTA reading/writing.

Behavioural contract follows the reference's rw_fasta
(SINA src/rw_fasta.cpp):
  - reader: name = text between '>' and first blank; remainder becomes
    the `full_name` attribute; ';key = value' comment lines before the
    sequence become attributes; sequences with invalid characters are
    skipped with a warning; transparent .gz; byte-range block sharding
    (--fasta-block/--fasta-idx) for external parallelisation.
  - writer: metadata as none/header "[k=v]"/comment/sidecar CSV;
    line wrapping; dots vs dashes; RNA vs DNA; --min-idty filter.
"""

from __future__ import annotations

import gzip
import io as _io
import logging
import sys
from pathlib import Path
from typing import Iterator, TextIO

from ..sequence import Sequence
from ..alphabet import BadCharacterError

logger = logging.getLogger("sina.fasta")

META_NONE = "none"
META_HEADER = "header"
META_COMMENT = "comment"
META_CSV = "csv"

# attribute never written to FASTA meta (too verbose; rw_fasta.cpp:476)
FN_FAMILY = "align_family_slv"
FN_FULLNAME = "full_name"


def _open_text(path, mode: str = "rt"):
    if str(path) == "-":
        if "r" in mode:
            return sys.stdin, False
        return sys.stdout, False
    p = Path(path)
    if p.suffix == ".gz":
        return gzip.open(p, mode), True
    return open(p, mode), True


def _open_binary_reader(path):
    if str(path) == "-":
        return sys.stdin.buffer, False
    p = Path(path)
    if p.suffix == ".gz":
        return gzip.open(p, "rb"), True
    return open(p, "rb"), True


def read_fasta(
    path,
    block_size: int = 0,
    block_idx: int = 0,
    use_native: bool = True,
) -> Iterator[Sequence]:
    """Yield Sequence records from a FASTA(.gz) file.

    With block_size > 0, only records whose '>' header begins in byte
    range [block_size*block_idx, block_size*(block_idx+1)) are yielded
    (semantics of rw_fasta.cpp:209-217,237-242: seek to block start,
    skip to next '>', stop after passing the block end).

    Plain uncompressed files without attribute comments go through the
    native C++ parser when available (../native).
    """
    if (
        use_native
        and block_size == 0
        and str(path) != "-"
        and Path(path).suffix != ".gz"
        and Path(path).is_file()
    ):
        from .. import native

        recs = native.parse_fasta_buffer(Path(path).read_bytes())
        if recs is not None:
            for name, full_name, positions, masks, width in recs:
                seq = Sequence(
                    name, positions, masks, width,
                    {FN_FULLNAME: full_name} if full_name else {},
                )
                yield seq
            return
    fh, close = _open_binary_reader(path)
    try:
        offset = 0
        if block_size > 0:
            if str(path) == "-":
                raise ValueError(
                    "Cannot use --fasta-block when input is piped"
                )
            fh.seek(block_size * block_idx)
            offset = block_size * block_idx
        end_byte = block_size * (block_idx + 1) if block_size > 0 else None

        name = None
        full_name = None
        attrs: dict[str, str] = {}
        chunks: list[bytes] = []

        def emit():
            if name is None:
                return None
            try:
                seq = Sequence.from_string(name, b"".join(chunks))
            except BadCharacterError as e:
                logger.error(
                    "Skipping sequence >%s (contains character %r)",
                    name, e.char,
                )
                return None
            if full_name:
                seq.attrs[FN_FULLNAME] = full_name
            seq.attrs.update(attrs)
            return seq

        while True:
            raw = fh.readline()
            if not raw:
                break
            line_start = offset
            offset += len(raw)
            if raw.startswith(b">"):
                s = emit()
                if s is not None:
                    yield s
                name = None
                if end_byte is not None and line_start >= end_byte:
                    return  # this record belongs to the next block
                text = raw.decode("utf-8", "replace").rstrip("\r\n")
                parts = text[1:].split(None, 1)
                name = parts[0] if parts else ""
                full_name = parts[1] if len(parts) > 1 else None
                attrs = {}
                chunks = []
            elif name is None:
                continue  # preamble junk before first '>'
            elif raw.startswith(b";"):
                body = raw.decode("utf-8", "replace")[1:].rstrip("\r\n")
                if "=" in body:
                    k, _, v = body.partition("=")
                    attrs[k.strip()] = v.strip()
            else:
                chunks.append(raw)
        s = emit()
        if s is not None:
            yield s
    finally:
        if close:
            fh.close()


class FastaWriter:
    """Streaming FASTA writer (rw_fasta.cpp:320-530 semantics)."""

    def __init__(
        self,
        path,
        meta: str = META_NONE,
        line_length: int = 0,
        dots: bool = False,
        dna: bool = False,
        min_idty: float = 0.0,
        copy_relatives: int = 0,
    ):
        self.fh, self._close = _open_text(path, "wt")
        self.meta = meta
        self.line_length = line_length
        self.dots = dots
        self.dna = dna
        self.min_idty = min_idty
        self.copy_relatives = copy_relatives
        self.count = 0
        self.excluded = 0
        self._relatives_written: set[str] = set()
        self._csv = None
        if meta == META_CSV:
            if str(path) == "-":
                logger.warning(
                    "meta-fmt csv needs a file output for the "
                    "sidecar CSV; metadata will not be written"
                )
            else:
                self._csv_path = Path(path).with_suffix(".csv")
                self._csv = open(self._csv_path, "w")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._csv:
            self._csv.close()
        if self._close:
            self.fh.close()

    def _esc(self, s: str) -> str:
        if not any(c in s for c in ',"\r\n'):
            return s
        return '"' + s.replace('"', '""') + '"'

    def write_result(self, seq: Sequence | None, relatives=None) -> bool:
        """Write an aligned result; returns False if excluded."""
        if seq is None:
            self.excluded += 1
            return False
        if self.min_idty > 0:
            idty = float(seq.get_attr("align_ident_slv", 0) or 0)
            if self.min_idty > idty:
                self.excluded += 1
                return False
        self.write(seq)
        if self.copy_relatives and relatives:
            for i, rel in enumerate(relatives):
                if i >= self.copy_relatives:
                    break
                if rel.name not in self._relatives_written:
                    self._relatives_written.add(rel.name)
                    self.write(rel)
        return True

    def write(self, seq: Sequence) -> None:
        out = self.fh
        header = ">" + seq.name
        full = seq.get_attr(FN_FULLNAME, "")
        if full:
            header += " " + str(full)
        meta_items = [
            (k, v)
            for k, v in seq.attrs.items()
            if k not in (FN_FAMILY, FN_FULLNAME)
        ]
        if self.meta == META_HEADER:
            for k, v in meta_items:
                sv = _fmt_value(v)
                if sv:
                    header += f" [{k}={sv}]"
            out.write(header + "\n")
        elif self.meta == META_COMMENT:
            out.write(header + "\n")
            for k, v in meta_items:
                out.write(f"; {k}={_fmt_value(v)}\n")
        elif self.meta == META_CSV and self._csv is not None:
            out.write(header + "\n")
            if self.count == 0:
                self._csv.write(
                    "name"
                    + "".join("," + self._esc(k) for k, _ in meta_items)
                    + "\r\n"
                )
            self._csv.write(
                self._esc(seq.name)
                + "".join(
                    "," + self._esc(_fmt_value(v)) for _, v in meta_items
                )
                + "\r\n"
            )
        else:
            out.write(header + "\n")

        s = seq.get_aligned(dots=self.dots, dna=self.dna)
        if self.line_length > 0:
            for i in range(0, len(s), self.line_length):
                out.write(s[i : i + self.line_length] + "\n")
        else:
            out.write(s + "\n")
        self.count += 1


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)
