"""IUPAC nucleotide alphabet as numpy lookup tables.

Semantics follow the reference implementation's 4-bit bitmask encoding
(SINA src/aligned_base.h:38-245, aligned_base.cpp:70-131):

  bit 0 (1)  = A
  bit 1 (2)  = G
  bit 2 (4)  = C
  bit 3 (8)  = T/U
  bit 4 (16) = lowercase marker

Ambiguity codes are unions of bits (e.g. R = A|G).  '-' and '.' encode
to 0 (gap).  Everything here is table-driven and vectorised so whole
sequences encode/decode as numpy array ops.
"""

from __future__ import annotations

import numpy as np

BASE_A = 0
BASE_G = 1
BASE_C = 2
BASE_TU = 3

M_A = 1 << BASE_A
M_G = 1 << BASE_G
M_C = 1 << BASE_C
M_TU = 1 << BASE_TU
M_LC = 1 << 4

GAP = 0  # bitmask value of '-' / '.'


def _build_char_to_mask() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint8)
    codes = {
        "A": M_A,
        "G": M_G,
        "C": M_C,
        "T": M_TU,
        "U": M_TU,
        "R": M_G | M_A,
        "Y": M_TU | M_C,
        "K": M_G | M_TU,
        "M": M_A | M_C,
        "S": M_G | M_C,
        "W": M_A | M_TU,
        "B": M_G | M_TU | M_C,
        "D": M_G | M_A | M_TU,
        "H": M_A | M_C | M_TU,
        "V": M_G | M_C | M_A,
        "N": M_A | M_G | M_C | M_TU,
    }
    for ch, m in codes.items():
        t[ord(ch)] = m
        t[ord(ch.lower())] = m | M_LC
    return t


CHAR_TO_MASK = _build_char_to_mask()

# mask (low 4 bits) -> display char, indexed by [mask | lowercase<<4]
# (SINA src/aligned_base.cpp:110-121)
_RNA = ".AGRCMSVUWKDYHBN"
_DNA = ".AGRCMSVTWKDYHBN"
MASK_TO_RNA = np.frombuffer(
    (_RNA + _RNA.lower()).encode(), dtype=np.uint8
).copy()
MASK_TO_DNA = np.frombuffer(
    (_DNA + _DNA.lower()).encode(), dtype=np.uint8
).copy()

# valid characters for sequence parsing: IUPAC codes plus gap chars
VALID_CHARS = np.zeros(256, dtype=bool)
VALID_CHARS[CHAR_TO_MASK != 0] = True
for _c in "-.":
    VALID_CHARS[ord(_c)] = True
WHITESPACE = np.zeros(256, dtype=bool)
for _c in " \t\n\r":
    WHITESPACE[ord(_c)] = True

# complement: swap A<->T/U, G<->C bits, keep lowercase bit
# (SINA src/aligned_base.h:117-124)
_m = np.arange(32, dtype=np.uint8)
COMPLEMENT = (
    ((_m & M_G) << (BASE_C - BASE_G))
    | ((_m & M_C) >> (BASE_C - BASE_G))
    | ((_m & M_A) << (BASE_TU - BASE_A))
    | ((_m & M_TU) >> (BASE_TU - BASE_A))
    | (_m & M_LC)
).astype(np.uint8)

# popcount of the low 4 bits, for ambiguity order
AMBIG_ORDER = np.array(
    [bin(v & 0xF).count("1") for v in range(32)], dtype=np.uint8
)

# 2-bit base index of an unambiguous mask (ctz), junk for ambiguous
BASE_INDEX = np.zeros(32, dtype=np.uint8)
for _i in range(4):
    BASE_INDEX[(1 << _i)] = _i
    BASE_INDEX[(1 << _i) | M_LC] = _i


class BadCharacterError(ValueError):
    """Raised when a sequence contains a non-IUPAC character."""

    def __init__(self, char: str):
        super().__init__(
            f"Character {char!r} not IUPAC encoded base or gap"
        )
        self.char = char


def encode(seq: str | bytes) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse a (possibly gapped) sequence string.

    Returns (positions, masks, width): `positions[i]` is the alignment
    column of base i, `masks[i]` its IUPAC bitmask; `width` the total
    number of alignment columns consumed.  Whitespace is skipped without
    advancing columns; '-' and '.' advance columns without emitting a
    base (semantics of cseq::append, SINA src/cseq.cpp:63-77).
    """
    if isinstance(seq, str):
        raw = np.frombuffer(seq.encode("ascii", "replace"), dtype=np.uint8)
    else:
        raw = np.frombuffer(seq, dtype=np.uint8)
    keep = ~WHITESPACE[raw]
    chars = raw[keep]
    bad = ~VALID_CHARS[chars]
    if bad.any():
        raise BadCharacterError(chr(int(chars[bad.argmax()])))
    width = len(chars)
    masks = CHAR_TO_MASK[chars]
    isbase = masks != 0
    positions = np.nonzero(isbase)[0].astype(np.uint32)
    return positions, masks[isbase], width


def decode(
    positions: np.ndarray,
    masks: np.ndarray,
    width: int,
    dots: bool = True,
    dna: bool = False,
) -> str:
    """Render a gapped string (cseq::getAligned,
    SINA src/cseq.cpp:135-174): unaligned leading/trailing
    gaps print as '.', internal gaps as '-' (unless dots=False)."""
    table = MASK_TO_DNA if dna else MASK_TO_RNA
    out = np.full(width, ord("-"), dtype=np.uint8)
    if len(positions):
        out[positions] = table[masks]
        if dots:
            first, last = int(positions[0]), int(positions[-1])
            out[:first] = ord(".")
            out[last + 1:] = ord(".")
    elif dots:
        out[:] = ord(".")
    return out.tobytes().decode("ascii")


def to_chars(masks: np.ndarray, dna: bool = False) -> str:
    """Ungapped bases string from masks."""
    table = MASK_TO_DNA if dna else MASK_TO_RNA
    return table[masks].tobytes().decode("ascii")


def comp_optimistic(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IUPAC-aware match: true if the codes could denote the same base
    (SINA src/aligned_base.h:153-160)."""
    return (a & b & 0xF) != 0


def comp_pessimistic(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Match only if a is unambiguous and codes are equal
    (SINA src/aligned_base.h:163-165)."""
    return (AMBIG_ORDER[a] == 1) & ((a & 0xF) == (b & 0xF))


def comp_exact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Match if codes equal ignoring case
    (SINA src/aligned_base.h:167-169)."""
    return (a & 0xF) == (b & 0xF)
