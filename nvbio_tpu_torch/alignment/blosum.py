"""Substitution-matrix scoring (protein Smith-Waterman).

Ref parity: examples/proteinsw/proteinsw.cu — local SW over a BLOSUM
substitution matrix.  ``MatrixScheme`` is a frozen (hashable, jit-
static) scheme the batched Gotoh engine accepts in place of
``GotohScheme``: substitution scores come from a matrix gather instead
of the match/mismatch formula.

The 20x20 core is the standard public BLOSUM62 table (row order
ARNDCQEGHILKMFPSTWYV).  X (unknown) scores -1 against everything and
'*' (stop) -4 against everything except '*'/'*' = +1, matching NCBI
conventions for those rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..basic.alphabet import PROTEIN_SYMBOLS

_BLOSUM62_20 = [
    # A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V
    [ 4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0],  # A
    [-1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3],  # R
    [-2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3],  # N
    [-2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3],  # D
    [ 0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],  # C
    [-1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2],  # Q
    [-1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2],  # E
    [ 0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3],  # G
    [-2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3],  # H
    [-1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3],  # I
    [-1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1],  # L
    [-1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2],  # K
    [-1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1],  # M
    [-2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1],  # F
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2],  # P
    [ 1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2],  # S
    [ 0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0],  # T
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3],  # W
    [-2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2, -2,  2,  7, -1],  # Y
    [ 0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -1,  4],  # V
]


def _blosum62_full() -> np.ndarray:
    m = np.full((PROTEIN_SYMBOLS, PROTEIN_SYMBOLS), -1, dtype=np.int32)
    m[:20, :20] = np.asarray(_BLOSUM62_20, dtype=np.int32)
    m[21, :] = -4  # '*'
    m[:, 21] = -4
    m[21, 21] = 1
    m[20, :20] = -1  # X
    m[:20, 20] = -1
    m[20, 20] = -1
    m[20, 21] = m[21, 20] = -4
    return m


@dataclass(frozen=True)
class MatrixScheme:
    """Substitution-matrix affine-gap scheme (jit-static).

    ``matrix`` is a tuple-of-tuples so the dataclass stays hashable;
    use ``.matrix_np`` / ``.matrix_jnp()`` for array forms.
    """

    matrix: tuple = field(default_factory=lambda: tuple(
        tuple(int(v) for v in row) for row in _blosum62_full()
    ))
    gap_open: int = 10  # BLAST-style gapped BLOSUM62 defaults (11/1 as
    gap_extend: int = 1  # open+extend for the first gap symbol)

    @property
    def matrix_np(self) -> np.ndarray:
        return np.asarray(self.matrix, dtype=np.int32)

    def substitution(self, a: int, b: int, q: int = 40) -> int:
        """Oracle-compatible scalar substitution score."""
        return int(self.matrix[a][b])


BLOSUM62 = MatrixScheme()
