"""Scalar NumPy alignment oracle — the ground truth for every DP kernel.

Serves the role of the reference's CPU-side checks in
``nvbio-test/alignment_test.cu`` (SURVEY.md §5.1: randomized inputs +
scalar CPU oracle, exact equality): a direct, loop-based Gotoh
affine-gap DP (full-matrix or banded) with explicit direction flags and
a shared traceback walk.  Small inputs only — this is a test oracle,
not a production path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .types import AlignmentType, GotohScheme, NEG_INF, gap_penalties

# H-cell direction flags
DIAG, FROM_E, FROM_F, ORIGIN = 0, 1, 2, 3


@dataclass
class AlignmentResult:
    score: int
    p_end: int  # pattern symbols consumed (exclusive end)
    t_end: int  # text symbols consumed (exclusive end)
    p_start: int = 0
    t_start: int = 0
    cigar: list = field(default_factory=list)  # [(op, length)] op in "MID"

    def cigar_string(self) -> str:
        return "".join(f"{l}{op}" for op, l in self.cigar) or "*"


def align_oracle(
    pattern: np.ndarray,
    text: np.ndarray,
    scheme: GotohScheme,
    atype: AlignmentType,
    band: int | None = None,
    quals: np.ndarray | None = None,
    traceback: bool = True,
) -> AlignmentResult:
    """Align `pattern` against `text`; returns score (+CIGAR).

    `band` is the half-width w: only cells with |j - i| <= w are
    computed (None = full matrix).  Follows the frozen conventions in
    ``types.py`` exactly.
    """
    pattern = np.asarray(pattern, dtype=np.int32)
    text = np.asarray(text, dtype=np.int32)
    M, N = len(pattern), len(text)
    eo, ee, fo, fe = gap_penalties(scheme)
    if quals is None:
        quals = np.full(M, 40, dtype=np.int32)

    H = np.full((M + 1, N + 1), NEG_INF, dtype=np.int64)
    # Hhat = H excluding the E term (diag/F only, local floor applied):
    # E gap-open compares against Hhat, not H — opening from an E-derived
    # cell is always dominated by extending (gap_open >= 0), and using
    # Hhat makes the open/extend tie-break decision identical between
    # this oracle and the max-plus-scan kernels.
    Hhat = np.full((M + 1, N + 1), NEG_INF, dtype=np.int64)
    E = np.full((M + 1, N + 1), NEG_INF, dtype=np.int64)
    F = np.full((M + 1, N + 1), NEG_INF, dtype=np.int64)
    flagH = np.full((M + 1, N + 1), ORIGIN, dtype=np.uint8)
    openE = np.zeros((M + 1, N + 1), dtype=bool)
    openF = np.zeros((M + 1, N + 1), dtype=bool)

    def in_band(i, j):
        return band is None or abs(j - i) <= band

    is_local = atype == AlignmentType.LOCAL
    # --- boundary row/col ---
    H[0][0] = 0
    Hhat[0][0] = 0
    for j in range(1, N + 1):
        if not in_band(0, j):
            continue
        if atype == AlignmentType.GLOBAL:
            E[0][j] = -(eo + j * ee)
            H[0][j] = E[0][j]
            flagH[0][j] = FROM_E
            openE[0][j] = j == 1
        else:  # SEMI_GLOBAL / LOCAL: free leading text
            H[0][j] = 0
            Hhat[0][j] = 0
    for i in range(1, M + 1):
        if not in_band(i, 0):
            continue
        if is_local:
            H[i][0] = 0
            Hhat[i][0] = 0
        else:  # leading pattern symbols = costed insertions
            F[i][0] = -(fo + i * fe)
            H[i][0] = F[i][0]
            Hhat[i][0] = F[i][0]
            flagH[i][0] = FROM_F
            openF[i][0] = i == 1

    # --- main DP ---
    for i in range(1, M + 1):
        for j in range(1, N + 1):
            if not in_band(i, j):
                continue
            s = scheme.substitution(int(pattern[i - 1]), int(text[j - 1]),
                                    int(quals[i - 1]))
            diag = H[i - 1][j - 1] + s if in_band(i - 1, j - 1) else NEG_INF
            # F: gap in text (consumes pattern), from above (full H:
            # opening after an E gap is a legal gap-close-gap path)
            if in_band(i - 1, j):
                f_open = H[i - 1][j] - fo - fe
                f_ext = F[i - 1][j] - fe
                F[i][j] = max(f_open, f_ext)
                openF[i][j] = f_open >= f_ext
            hh = max(diag, F[i][j])
            if is_local:
                hh = max(hh, 0)
            Hhat[i][j] = hh
            # E: gap in pattern (consumes text), from the left.
            if in_band(i, j - 1):
                e_open = Hhat[i][j - 1] - eo - ee
                e_ext = E[i][j - 1] - ee
                E[i][j] = max(e_open, e_ext)
                openE[i][j] = e_open >= e_ext
            best = max(hh, E[i][j])
            if is_local and best <= 0:
                H[i][j] = 0
                flagH[i][j] = ORIGIN
            else:
                H[i][j] = best
                if best == diag:
                    flagH[i][j] = DIAG
                elif best == E[i][j]:
                    flagH[i][j] = FROM_E
                else:
                    flagH[i][j] = FROM_F

    # --- pick the sink ---
    if atype == AlignmentType.GLOBAL:
        bi, bj = M, N
        score = int(H[M][N])
    elif atype == AlignmentType.SEMI_GLOBAL:
        row = H[M]
        bj = int(np.argmax(row))  # first max = smallest j
        bi, score = M, int(row[bj])
    else:
        flat = int(np.argmax(H))  # row-major: smallest i, then smallest j
        bi, bj = divmod(flat, N + 1)
        score = int(H[bi][bj])

    res = AlignmentResult(score=score, p_end=bi, t_end=bj)
    if traceback:
        ops, (si, sj) = walk_directions(flagH, openE, openF, bi, bj)
        res.cigar = ops
        res.p_start, res.t_start = si, sj
    return res


def walk_directions(flagH, openE, openF, i, j):
    """Walk direction flags back from H-cell (i, j); returns
    (run-length CIGAR ops in forward order, (p_start, t_start))."""
    rev = []
    state = "H"
    while True:
        if state == "H":
            f = flagH[i][j]
            if f == ORIGIN:
                break
            if f == DIAG:
                rev.append("M")
                i, j = i - 1, j - 1
            elif f == FROM_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            rev.append("D")
            was_open = openE[i][j]
            j -= 1
            if was_open:
                state = "H"
        else:
            rev.append("I")
            was_open = openF[i][j]
            i -= 1
            if was_open:
                state = "H"
    ops = []
    for op in reversed(rev):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return [(op, l) for op, l in ops], (i, j)
