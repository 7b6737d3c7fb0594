"""Seeded protein pair sets on which a column-sweep DP of K5's matrix mode
tends to break, shared by ``tests/test_torch_protein.py`` (the plain
version against the JAX twin on the CPU) and ``tests/test_torch_cuda.py``
(the kernel against the plain version on the card), so that kernel =
plain there means kernel = JAX.  numpy only (the card's machine has no
JAX).

- ``repeats``: low-complexity proteins, a periodic query (period 1-4)
  inside a periodic target, some with the same motif, so that equal
  maxima sit on several rows and columns;
- ``clipped``: symbols from -6 to 39, outside the table's [0, K - 1],
  which the substitution clips, with planted copies;
- ``empty``: zero-length queries, zero-length targets, both, and
  one-residue sides beside ordinary pairs.
"""

import numpy as np

KINDS = ("repeats", "clipped", "empty")
#: pairs, query and target width of every kind
NB, LQ, LT = 16, 64, 96


def pairs(kind: str):
    """(pats, plens, texts, tlens) int32 numpy arrays of one kind."""
    rng = np.random.default_rng(1700 + KINDS.index(kind))
    pats = rng.integers(0, 20, (NB, LQ))
    texts = rng.integers(0, 20, (NB, LT))
    plens = rng.integers(LQ // 2, LQ + 1, NB)
    tlens = rng.integers(LT // 2, LT + 1, NB)
    if kind == "repeats":
        for b in range(NB):
            period = 1 + b % 4
            motif = rng.integers(0, 20, period)
            pats[b] = np.tile(motif, LQ)[:LQ]
            # the target repeats the same motif (shifted) on even lanes,
            # another motif of the same period around a copy on odd ones
            back = motif if b % 2 == 0 else rng.integers(0, 20, period)
            shift = int(rng.integers(0, period))
            texts[b] = np.tile(back, 2 * LT)[shift:shift + LT]
            if b % 2:
                m = int(rng.integers(8, LQ // 2))
                s = int(rng.integers(0, LT - m))
                texts[b, s:s + m] = pats[b, :m]
        plens[:2], tlens[2:4] = LQ, LT
    elif kind == "clipped":
        pats = rng.integers(-6, 40, (NB, LQ))
        texts = rng.integers(-6, 40, (NB, LT))
        for b in range(0, NB, 2):  # homologs keep the scores positive
            m = int(min(plens[b], tlens[b]))
            s = int(rng.integers(0, tlens[b] - m + 1))
            texts[b, s:s + m] = pats[b, :m]
    else:  # empty
        plens[[0, 2, 5]] = 0
        tlens[[1, 2, 6]] = 0
        plens[3], tlens[4] = 1, 1
        plens[7], tlens[7] = LQ, LT
    return (pats.astype(np.int32), plens.astype(np.int32),
            texts.astype(np.int32), tlens.astype(np.int32))
