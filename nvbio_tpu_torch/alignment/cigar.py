"""Traceback walk over banded direction flags → CIGAR / MD / NM.

Host-side equivalent of the reference's traceback + CIGAR/MDS
construction (ref: nvbio/alignment/alignment_base_inl.h —
``alignment_traceback``; nvBowtie/bowtie2/cuda/traceback_inl.h —
``finish_alignment_best``; mds.h).  The device kernels emit a dense
per-cell direction matrix in band coordinates (winners-only batches, so
it is small); this module walks it on the host.

Band coordinates: DP cell (i, j) lives at k = j - i + w; dirs[i-1, k]
holds the flags of DP row i (i >= 1).
"""

from __future__ import annotations

import numpy as np

from .types import AlignmentType

DIAG, FROM_E, FROM_F, ORIGIN = 0, 1, 2, 3


def traceback_banded(
    dirs: np.ndarray,  # (Lp, BAND) uint8 flags for one alignment
    p_end: int,
    t_end: int,
    band_w: int,
    atype: AlignmentType,
):
    """Walk flags back from DP cell (p_end, t_end).

    Returns (cigar_ops [(op, len)] forward order with op in "MID",
    p_start, t_start).
    """
    dirs = np.asarray(dirs)
    i = int(p_end)
    k = int(t_end) - i + band_w
    rev = []
    state = "H"
    while True:
        if state == "H":
            if i == 0:
                break
            f = dirs[i - 1, k] & 3
            if f == ORIGIN:
                break
            if f == DIAG:
                rev.append("M")
                i -= 1  # k unchanged: (i-1, j-1) has same band coord
            elif f == FROM_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            rev.append("D")
            was_open = (dirs[i - 1, k] >> 2) & 1
            k -= 1
            if was_open:
                state = "H"
        else:  # F
            rev.append("I")
            was_open = (dirs[i - 1, k] >> 3) & 1
            i -= 1
            k += 1
            if was_open:
                state = "H"
    j = i + k - band_w
    if atype == AlignmentType.GLOBAL and j > 0:
        rev.extend("D" * j)  # leading text consumed as deletions
        j = 0
    ops = []
    for op in reversed(rev):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return [(op, l) for op, l in ops], i, j


def cigar_to_string(cigar, p_start=0, p_len=None) -> str:
    """Render run-length ops as a SAM CIGAR, adding soft clips for
    unaligned pattern ends when `p_len` is given."""
    parts = []
    if p_start:
        parts.append(f"{p_start}S")
    parts.extend(f"{l}{op}" for op, l in cigar)
    if p_len is not None:
        consumed = p_start + sum(l for op, l in cigar if op in "MI")
        if p_len - consumed > 0:
            parts.append(f"{p_len - consumed}S")
    return "".join(parts) or "*"


def make_md_string(
    pattern: np.ndarray,
    text: np.ndarray,
    p_start: int,
    t_start: int,
    cigar,
    to_char=None,
) -> tuple[str, int]:
    """Build the SAM MD tag and NM edit distance from an alignment path.

    `pattern`/`text` are symbol arrays; `to_char` maps symbols to
    characters (default DNA)."""
    if to_char is None:
        from ..basic.alphabet import dna_to_char

        to_char = lambda s: chr(int(dna_to_char(np.uint8(s))))
    i, j = p_start, t_start
    md = []
    run = 0
    nm = 0
    for op, length in cigar:
        if op == "M":
            for _ in range(length):
                if pattern[i] == text[j] and pattern[i] < 4:
                    run += 1
                else:
                    md.append(str(run))
                    md.append(to_char(text[j]))
                    run = 0
                    nm += 1
                i += 1
                j += 1
        elif op == "I":
            i += length
            nm += length
        elif op == "D":
            md.append(str(run))
            run = 0
            md.append("^" + "".join(to_char(text[j + x]) for x in range(length)))
            j += length
            nm += length
    md.append(str(run))
    return "".join(md), nm
