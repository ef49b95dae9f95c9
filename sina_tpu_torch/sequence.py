"""Sequence data model: the cseq equivalent.

A Sequence stores only its bases — parallel numpy arrays of alignment
positions (uint32) and IUPAC bitmasks (uint8) — plus the alignment
width and a typed attribute dict.  This mirrors the reference's
"compressed sequence" (SINA src/cseq.h:50-281) which the
reference uses to keep 50k-column alignments cheap; for us it is also
the natural host-side form to batch into padded device arrays.
"""

from __future__ import annotations

import copy as _copy
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

from . import alphabet


@dataclass
class Sequence:
    name: str = ""
    positions: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.uint32)
    )
    masks: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.uint8)
    )
    width: int = 0
    attrs: dict[str, Any] = field(default_factory=dict)

    # -- construction -------------------------------------------------

    @classmethod
    def from_string(cls, name: str, seq: str | bytes, **attrs) -> "Sequence":
        positions, masks, width = alphabet.encode(seq)
        return cls(name, positions, masks, width, dict(attrs))

    def copy(self) -> "Sequence":
        return Sequence(
            self.name,
            self.positions.copy(),
            self.masks.copy(),
            self.width,
            _copy.deepcopy(self.attrs),
        )

    # -- basic queries ------------------------------------------------

    def __len__(self) -> int:
        return len(self.positions)

    @property
    def size(self) -> int:
        return len(self.positions)

    def get_bases(self, dna: bool = False) -> str:
        return alphabet.to_chars(self.masks, dna=dna)

    def get_aligned(self, dots: bool = True, dna: bool = False) -> str:
        return alphabet.decode(
            self.positions, self.masks, self.width, dots=dots, dna=dna
        )

    def internal_gaps(self) -> int:
        """Gap columns before the last base: last position - nbases + 1
        (famfinder fs-req-gaps test, SINA src/famfinder.cpp:474-480;
        note the reference counts leading gap columns too)."""
        if len(self.positions) == 0:
            return 0
        return int(self.positions[-1]) - len(self.positions) + 1

    def iter_bases(self) -> Iterator[tuple[int, int]]:
        return zip(self.positions.tolist(), self.masks.tolist())

    # -- attribute handling ------------------------------------------

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def get_attr(self, key: str, default: Any = None) -> Any:
        return self.attrs.get(key, default)

    # -- transforms ---------------------------------------------------

    def reverse(self) -> "Sequence":
        """In-place reverse (cseq::reverse, SINA src/cseq.cpp:283-289)."""
        self.positions = (self.width - 1 - self.positions[::-1]).astype(
            np.uint32
        )
        self.masks = self.masks[::-1].copy()
        return self

    def complement(self) -> "Sequence":
        self.masks = alphabet.COMPLEMENT[self.masks]
        return self

    def upper_case_all(self) -> "Sequence":
        self.masks = (self.masks & 0xF).astype(np.uint8)
        return self

    def set_width(self, new_width: int) -> None:
        """Grow/shrink alignment width; on shrink, packs trailing bases
        leftward as needed (cseq::setWidth, SINA src/cseq.cpp:98-132)."""
        n = len(self.positions)
        if n == 0 or new_width >= int(self.positions[-1]) + 1:
            self.width = int(new_width)
            return
        if new_width < n:
            raise ValueError(
                f"Cannot shrink '{self.name}' alignment width to "
                f"{new_width} - got {n} bases"
            )
        # move the minimal suffix of bases left so they fit
        skip = 0
        while skip < n:
            if int(self.positions[n - skip - 1]) + skip < new_width:
                break
            skip += 1
        for i in range(skip, 0, -1):
            self.positions[n - i] = new_width - i
        self.width = int(new_width)

    # -- NAST insertion shifting --------------------------------------

    def fix_duplicate_positions(self, lowercase: bool = False) -> dict:
        """Re-place bases that share an alignment position ("insertions"
        the reference alignment cannot accommodate) by shifting them
        into nearby gap columns.

        Port of the semantics of cseq::fix_duplicate_positions
        (SINA src/cseq.cpp:457-594): each run of duplicate
        positions is placed right-aligned against its right anchor; if
        the local gap window is too small the window is grown towards
        whichever side has the nearest free gap column, absorbing the
        bases in between into the re-placement.
        """
        pos = self.positions.astype(np.int64)
        n = len(pos)
        stats = {"total_inserts": 0, "longest_insert": 0}
        if n == 0:
            return stats
        if n > 1 and (np.diff(pos) > 0).all():
            return stats  # strictly increasing: nothing to fix
        lower = np.zeros(n, dtype=bool)

        last = 0  # index of last properly placed base
        curr = 1
        while curr <= n:
            if curr < n and pos[curr] == pos[last]:
                # duplicate -> keep scanning unless at final base
                if curr + 1 < n:
                    curr += 1
                    continue
                curr += 1  # final base: fall through to placement
            num_inserts = curr - last - 1
            if num_inserts == 0:
                last = curr
                curr += 1
                continue

            # open interval for placement
            range_begin = int(pos[last]) + 1
            range_end = int(pos[curr]) if curr < n else self.width
            lo = last + 1   # first base to re-place
            hi = curr - 1   # last base to re-place

            if range_end - range_begin < num_inserts:
                while range_end - range_begin < num_inserts:
                    # nearest free gap column left of range
                    left = lo
                    if left == 0:
                        next_left_gap = range_begin - 1 if range_begin > 0 else -1
                    elif pos[left - 1] + 1 < range_begin:
                        next_left_gap = range_begin - 1
                    else:
                        left -= 1
                        while left > 0 and pos[left - 1] + 1 >= pos[left]:
                            left -= 1
                        next_left_gap = int(pos[left]) - 1
                    # nearest free gap column right of range
                    right = hi
                    if right + 1 == n:
                        next_right_gap = (
                            range_end if range_end < self.width else -1
                        )
                    elif pos[right + 1] > range_end:
                        next_right_gap = range_end
                    else:
                        right += 1
                        while (
                            right + 1 < n
                            and pos[right] + 1 >= pos[right + 1]
                        ):
                            right += 1
                        next_right_gap = int(pos[right]) + 1

                    if next_right_gap == -1 or (
                        next_left_gap != -1
                        and range_begin - next_left_gap
                        <= next_right_gap - (range_end - 1)
                    ):
                        if next_left_gap == -1:
                            raise RuntimeError(
                                "no space to left and right - "
                                "sequence longer than alignment?"
                            )
                        num_inserts += lo - left
                        range_begin = next_left_gap
                        lo = left
                    else:
                        num_inserts += right - hi
                        range_end = next_right_gap + 1
                        hi = right
            else:
                range_begin = range_end - num_inserts

            pos[lo : hi + 1] = np.arange(
                range_begin, range_begin + (hi - lo + 1), dtype=np.int64
            )
            if lowercase:
                lower[lo : hi + 1] = True

            stats["total_inserts"] += num_inserts
            stats["longest_insert"] = max(
                stats["longest_insert"], num_inserts
            )
            last = curr
            curr += 1

        self.positions = pos.astype(np.uint32)
        if lowercase and lower.any():
            self.masks = np.where(
                lower, self.masks | alphabet.M_LC, self.masks
            ).astype(np.uint8)
        return stats

    # -- alignment diffing --------------------------------------------

    def find_differing_parts(
        self, other: "Sequence"
    ) -> list[tuple[int, int]]:
        """Column ranges where this and `other` disagree (position or
        base), merged with a 4-base cool-down (port of
        cseq::find_differing_parts, SINA src/cseq.cpp:
        596-648); used by --show-diff."""
        l_pos, r_pos = self.positions, other.positions
        l_mask, r_mask = self.masks & 0xF, other.masks & 0xF
        li = ri = 0
        ln, rn = len(l_pos), len(r_pos)
        result: list[tuple[int, int]] = []
        score = 0
        bad = False
        start = 0
        lpos = int(l_pos[0]) if ln else 0
        rpos = int(r_pos[0]) if rn else 0
        while li < ln and ri < rn:
            if lpos < rpos:
                score = 4
                li += 1
            elif rpos < lpos:
                score = 4
                ri += 1
            else:
                if l_mask[li] != r_mask[ri]:
                    score = 4
                li += 1
                ri += 1
            if li < ln:
                lpos = int(l_pos[li])
            if ri < rn:
                rpos = int(r_pos[ri])
            if score > 0:
                if not bad:
                    back = int(r_pos[max(0, ri - 2)])
                    start = min(lpos, back)
                    bad = True
                else:
                    score -= 1
                    if score <= 0 and lpos == rpos:
                        result.append((start, lpos))
                        bad = False
        if bad:
            result.append((start, min(lpos, rpos)))
        return result

    # -- pair score ---------------------------------------------------

    def calc_pair_score(self, pairs: np.ndarray) -> float:
        """Secondary-structure pairing score (cseq::calcPairScore,
        SINA src/cseq.cpp:651-733).  `pairs[i]` holds the
        partner column of column i (0 = unpaired)."""
        scores = {
            ("A", "G"): 0.5, ("A", "U"): 1.1, ("C", "G"): 1.5,
            ("G", "G"): 0.4, ("G", "U"): 0.9,
        }
        # gapped chars, case-preserving; gap columns are '-' like the
        # reference's cseq::operator[] (lowercase pairings count toward
        # num but score 0, as in the reference's char-indexed table)
        cols = np.frombuffer(
            self.get_aligned(dots=False).encode(), dtype=np.uint8
        )
        num = 0
        total = 0.0
        w = self.width
        for i in range(min(len(pairs), w)):
            p = int(pairs[i])
            if p == 0 or p >= w:
                continue
            left = chr(cols[i])
            right = chr(cols[p])
            if left == "-" and right == "-":
                continue
            num += 1
            key = (left, right) if left < right else (right, left)
            total += scores.get(key, 0.0)
        return total / num if num else 0.0
