"""Per-sequence result attributes + aggregate accuracy metrics.

Port of the semantics of Log::printer
(SINA src/log.cpp:255-431): per sequence it sets the helix
pair score, nuc count and alignment start/stop attributes and logs all
attributes; with show_dist it accumulates

  sps  — exact-IUPAC identity of the new vs the original alignment
  idty — optimistic identity of the original vs its closest reference
  cpm  — drop in closest-reference identity caused by realignment

reported as avg_sps / avg_cpm / avg_idty / avg_bps at teardown
(the accuracy-regression currency of tests/accuracy.test:33-40).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from .comparator import (
    Comparator,
    IUPAC_EXACT,
    IUPAC_OPTIMISTIC,
    COVER_QUERY,
)
from .sequence import Sequence

logger = logging.getLogger("sina.stats")


_BASE_COLORS = {
    "A": "\033[34m", "a": "\033[34m",
    "G": "\033[35m", "g": "\033[35m",
    "C": "\033[32m", "c": "\033[32m",
    "T": "\033[33m", "t": "\033[33m",
    "U": "\033[33m", "u": "\033[33m",
}


def color_code(text: str) -> str:
    """ANSI-color bases like the reference (--colors,
    cseq.cpp:319-360): A blue, G magenta, C green, T/U yellow."""
    out = []
    colored = False
    for ch in text:
        code = _BASE_COLORS.get(ch)
        if code is not None:
            out.append(code)
            colored = True
        elif colored:
            out.append("\033[0m")
            colored = False
        out.append(ch)
    if colored:
        out.append("\033[0m")
    return "".join(out)


def write_alignment(
    seqs: list[Sequence], from_pos: int, to_pos: int,
    colors: bool = False,
) -> str:
    """Textual dump of an alignment region over several sequences,
    deduplicating identical rows (cseq::write_alignment semantics,
    SINA src/cseq.cpp:361-454)."""
    if not seqs:
        return "write_alignment(): no sequences?\n"
    width = seqs[0].width
    if from_pos > to_pos or to_pos >= width:
        return "write_alignment(): range out of bounds!\n"
    rows = []
    for s in seqs:
        text = s.get_aligned(dots=False)[from_pos : to_pos + 1]
        rows.append(text)
    # drop all-gap columns like the reference
    keep = [
        i
        for i in range(len(rows[0]))
        if any(r[i] != "-" for r in rows) or i == len(rows[0]) - 1
    ]
    rows = ["".join(r[i] for i in keep) for r in rows]
    groups: dict[str, list[int]] = {}
    for i, r in enumerate(rows):
        groups.setdefault(r, []).append(i)
    out = [f"Dumping pos {from_pos} through {to_pos}:"]
    n = len(seqs)
    for text, members in sorted(groups.items()):
        tags = ""
        if n - 1 in members:
            tags += " <---(## NEW ##)"
        if n - 2 in members:
            tags += " <---(%% ORIG %%)"
        ids = ",".join(str(m) for m in members)
        shown = color_code(text) if colors else text
        out.append(f"{shown} {ids}{tags}")
    return "\n".join(out) + "\n"


@dataclass
class StatsPrinter:
    show_dist: bool = False
    show_diff: bool = False
    colors: bool = False
    helix_pairs: np.ndarray | None = None
    orig_db: object = None  # optional ReferenceDb with originals

    sequence_num: int = 0
    total_sps: float = 0.0
    total_cpm: float = 0.0
    total_idty: float = 0.0
    total_bps: float = 0.0

    def __call__(
        self,
        orig: Sequence,
        aligned: Sequence | None,
        reference: list[tuple[float, Sequence]] | None,
        seqno: int,
        log_text: str = "",
    ) -> None:
        logger.info("sequence_number: %d", seqno)
        logger.info("sequence_identifier: %s", orig.name)
        if aligned is None:
            logger.info("alignment failed!")
            return
        self.sequence_num += 1

        if self.helix_pairs is not None and len(self.helix_pairs):
            bps = aligned.calc_pair_score(self.helix_pairs)
            self.total_bps += bps
            aligned.set_attr("align_bp_score_slv", int(100 * bps))
        aligned.set_attr("nuc", len(aligned))
        if len(aligned):
            aligned.set_attr(
                "align_startpos_slv", int(aligned.positions[0])
            )
            aligned.set_attr(
                "align_stoppos_slv", int(aligned.positions[-1])
            )
        else:
            aligned.set_attr("align_startpos_slv", 0)
            aligned.set_attr("align_stoppos_slv", 0)
        for k, v in aligned.attrs.items():
            logger.info("%s: %s", k, v)

        if self.show_dist:
            self._show_dist(orig, aligned, reference or [])
        if self.show_diff:
            refs = [r for _, r in (reference or [])]
            for lo, hi in orig.find_differing_parts(aligned):
                logger.info(
                    "\n%s",
                    write_alignment(
                        refs + [orig, aligned], lo, hi,
                        colors=self.colors,
                    ),
                )

    def _show_dist(self, orig, aligned, reference):
        if self.orig_db is not None:
            try:
                orig = self.orig_db.get(orig.name)
            except KeyError:
                pass
        if orig.width != aligned.width:
            logger.error(
                "Cannot show dist - %s and %s have widths %d and %d",
                orig.name, aligned.name, orig.width, aligned.width,
            )
            return
        cmp_exact = Comparator(
            IUPAC_EXACT, "none", COVER_QUERY, False
        )
        sps = cmp_exact(orig, aligned)
        logger.info("orig_idty: %.6f", sps)
        self.total_sps += sps
        if not reference:
            logger.info("reference / search result empty?")
            return
        cmp_opt = Comparator(
            IUPAC_OPTIMISTIC, "none", COVER_QUERY, False
        )
        scored = [(cmp_opt(orig, r), r) for _, r in reference]
        orig_idty, closest = max(scored, key=lambda t: t[0])
        self.total_idty += orig_idty
        aligned_idty = cmp_opt(aligned, closest)
        cpm = orig_idty - aligned_idty
        logger.info("orig_closest_idty: %.6f", orig_idty)
        logger.info("cpm: %.6f", cpm)
        self.total_cpm += cpm

    def summary(self) -> dict:
        n = max(self.sequence_num, 1)
        return {
            "avg_sps": self.total_sps / n,
            "avg_cpm": self.total_cpm / n,
            "avg_idty": self.total_idty / n,
            "avg_bps": self.total_bps / n,
        }

    def log_summary(self) -> None:
        if self.show_dist:
            s = self.summary()
            logger.warning("avg_sps: %.6f", s["avg_sps"])
            logger.warning("avg_cpm: %.6f", s["avg_cpm"])
            logger.warning("avg_idty: %.6f", s["avg_idty"])
            logger.warning("avg_bps: %.6f", s["avg_bps"])
