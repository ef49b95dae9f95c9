"""Plain reference of the aligner's finish: from the DP's traceback to
the query's columns in the reference alignment (SINA's mesh.h:534-739
and cseq.cpp:457-594, with --overhang attach, --insertion shift).

Unaligned ends are attached next to the aligned body; bases that land
in one column ("insertions" the alignment has no room for) are shifted
into the nearest free columns, right-aligned against their right
anchor, the window growing towards the side with the nearer free
column.  NumPy; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def finish_columns(emit: np.ndarray, qlen: int, best_c: int, best_i: int, cols: np.ndarray,
                   width: int) -> np.ndarray:
    """The query's alignment columns, one a base, from the traceback's
    emit (the profile column of each query base, -1 none), the DP's end
    (best_c, best_i) and the profile's occupied columns."""
    emit = emit[:qlen]
    eidx = np.flatnonzero(emit >= 0)
    head = int(eidx[0]) if len(eidx) else 0
    tail = qlen - 1 - best_i
    parts = []
    if head > 0:
        first = int(cols[emit[eidx[0]]])
        parts.append(np.maximum(0, first - (head - np.arange(head))))
    parts.append(cols[emit[eidx]].astype(np.int64))
    if tail > 0:
        last = int(cols[best_c])
        parts.append(np.minimum(width - 1, last + 1 + np.arange(tail)))
    pos = np.maximum.accumulate(np.concatenate(parts).astype(np.int64))
    return shift_duplicates(pos, width)


def shift_duplicates(pos: np.ndarray, width: int) -> np.ndarray:
    """Re-place runs of bases that share a column into free columns
    (cseq::fix_duplicate_positions)."""
    pos = pos.copy()
    n = len(pos)
    if n == 0 or (n > 1 and (np.diff(pos) > 0).all()):
        return pos
    last, curr = 0, 1
    while curr <= n:
        if curr < n and pos[curr] == pos[last]:
            if curr + 1 < n:
                curr += 1
                continue
            curr += 1
        n_ins = curr - last - 1
        if n_ins == 0:
            last = curr
            curr += 1
            continue
        begin = int(pos[last]) + 1
        end = int(pos[curr]) if curr < n else width
        lo, hi = last + 1, curr - 1
        if end - begin < n_ins:
            while end - begin < n_ins:
                left = lo
                if left == 0:
                    left_gap = begin - 1 if begin > 0 else -1
                elif pos[left - 1] + 1 < begin:
                    left_gap = begin - 1
                else:
                    left -= 1
                    while left > 0 and pos[left - 1] + 1 >= pos[left]:
                        left -= 1
                    left_gap = int(pos[left]) - 1
                right = hi
                if right + 1 == n:
                    right_gap = end if end < width else -1
                elif pos[right + 1] > end:
                    right_gap = end
                else:
                    right += 1
                    while right + 1 < n and pos[right] + 1 >= pos[right + 1]:
                        right += 1
                    right_gap = int(pos[right]) + 1
                if right_gap == -1 or (left_gap != -1
                                       and begin - left_gap <= right_gap - (end - 1)):
                    if left_gap == -1:
                        raise RuntimeError("no free column on either side")
                    n_ins += lo - left
                    begin = left_gap
                    lo = left
                else:
                    n_ins += right - hi
                    end = right_gap + 1
                    hi = right
        else:
            begin = end - n_ins
        pos[lo:hi + 1] = np.arange(begin, begin + (hi - lo + 1))
        last = curr
        curr += 1
    return pos
