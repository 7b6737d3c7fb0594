"""DNA alphabets and symbol<->character conversion.

Re-designs the reference's alphabet layer (ref: nvbio/basic/dna.h,
nvbio/strings/alphabet.h — ``char_to_dna``, ``dna_to_char``, ``DNA``,
``DNA_N``) as vectorized NumPy lookup tables.

Encoding (2-bit DNA): A=0, C=1, G=2, T=3.  The extended ``DNA_N``
encoding used for *reads* adds N=4 (stored unpacked as int8; packed
genome streams are strictly 2-bit with ambiguous bases substituted at
index-build time, as the reference's nvBWT does).

A copy of ``nvbio_tpu/basic/alphabet.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
DNA_SYMBOLS = 4
#: symbol value used for 'N'/unknown in unpacked int8 read arrays
N_SYMBOL = N

_CHAR_TO_DNA = np.full(256, N, dtype=np.uint8)
for _ch, _v in [("A", A), ("C", C), ("G", G), ("T", T),
                ("a", A), ("c", C), ("g", G), ("t", T)]:
    _CHAR_TO_DNA[ord(_ch)] = _v

_DNA_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()

# complement of {A,C,G,T,N} -> {T,G,C,A,N}
_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def char_to_dna(chars: np.ndarray) -> np.ndarray:
    """Map ASCII codes (uint8) to 2-bit DNA symbols (N and anything
    unrecognized -> 4)."""
    return _CHAR_TO_DNA[chars]


def dna_to_char(symbols: np.ndarray) -> np.ndarray:
    """Map DNA symbols (0..4) back to ASCII codes."""
    return _DNA_TO_CHAR[symbols]


def encode_dna(seq: str | bytes) -> np.ndarray:
    """Encode a DNA string to an int8 symbol array (A=0..T=3, N=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return char_to_dna(np.frombuffer(seq, dtype=np.uint8))


def decode_dna(symbols: np.ndarray) -> str:
    """Decode a symbol array back to a DNA string."""
    return dna_to_char(np.asarray(symbols, dtype=np.uint8)).tobytes().decode("ascii")


def complement(symbols: np.ndarray) -> np.ndarray:
    """Complement symbols (N maps to N)."""
    return _COMPLEMENT[symbols]


def reverse_complement(symbols: np.ndarray) -> np.ndarray:
    """Reverse-complement a symbol array."""
    return _COMPLEMENT[symbols][::-1]


# ---------------------------------------------------------------------------
# Protein alphabet (ref: nvbio/strings/alphabet.h — ``PROTEIN``; 20 amino
# acids in BLOSUM row order, plus X = unknown and '*' = stop).
# ---------------------------------------------------------------------------

PROTEIN_CHARS = "ARNDCQEGHILKMFPSTWYVX*"
PROTEIN_SYMBOLS = len(PROTEIN_CHARS)  # 22
PROTEIN_X = PROTEIN_CHARS.index("X")

_CHAR_TO_PROTEIN = np.full(256, PROTEIN_X, dtype=np.uint8)
for _i, _ch in enumerate(PROTEIN_CHARS):
    _CHAR_TO_PROTEIN[ord(_ch)] = _i
    _CHAR_TO_PROTEIN[ord(_ch.lower())] = _i
# common IUPAC ambiguity codes fold to near equivalents
_CHAR_TO_PROTEIN[ord("B")] = PROTEIN_CHARS.index("N")
_CHAR_TO_PROTEIN[ord("Z")] = PROTEIN_CHARS.index("Q")
_CHAR_TO_PROTEIN[ord("U")] = PROTEIN_CHARS.index("C")  # selenocysteine

_PROTEIN_TO_CHAR = np.frombuffer(PROTEIN_CHARS.encode(), dtype=np.uint8).copy()


def encode_protein(seq: str | bytes) -> np.ndarray:
    """Encode a protein string to int8 symbols (unknown -> X)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _CHAR_TO_PROTEIN[np.frombuffer(seq, dtype=np.uint8)]


def decode_protein(symbols: np.ndarray) -> str:
    return _PROTEIN_TO_CHAR[np.asarray(symbols, dtype=np.uint8)].tobytes().decode()
