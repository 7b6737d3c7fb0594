"""Seeded batches on which a banded column sweep of K5's formula score
entry point tends to break, shared by ``tests/test_torch_wavefront.py``
(the plain version against the JAX kernel and twin on the CPU) and
``tests/test_torch_cuda.py`` (the kernel's banded tier against the plain
version on the card), so that kernel = plain there means kernel = JAX.
numpy only (the card's machine has no JAX).

Four lanes, each a sweep edge (strips of 256 rows, 8 rows a lane):

- lane 0: a periodic pattern (period 3) inside a text of the same period,
  shifted, so that equal maxima sit on many rows and columns; plen
  min(256, Lp): one strip exactly;
- lane 1: plen min(257, Lp), one row into the next strip, and a text long
  enough that GLOBAL's goal column is clipped to the band's upper edge
  (tlen - plen > band_w where Lt allows);
- lane 2: plen Lp, with tlen below the band of the last strip's rows
  (GLOBAL's goal clipped to -band_w, the last strip's window empty);
- lane 3: plen Lp, tlen Lt, a mutated planted copy of the pattern.

Every lane has N symbols (4) in pattern and text and qualities 0-41.
"""

import numpy as np

NB = 4


def batch(lp: int, band_w: int, lt: int, seed: int = 0):
    """(pats, plens, texts, tlens, quals): int8, int32, int8, int32,
    uint8 numpy arrays of NB lanes at pattern width ``lp`` and text width
    ``lt``."""
    rng = np.random.default_rng(1800 + seed)
    pats = rng.integers(0, 4, (NB, lp))
    texts = rng.integers(0, 4, (NB, lt))
    motif = rng.integers(0, 4, 3)
    pats[0] = np.tile(motif, lp)[:lp]
    texts[0] = np.tile(motif, 2 * lt)[1:lt + 1]
    m = lp - lp // 10
    s = int(rng.integers(0, max(lt - m, 0) + 1))
    seg = pats[3, :m].copy()
    mut = rng.random(m) < 0.03
    seg[mut] = rng.integers(0, 4, int(mut.sum()))
    texts[3, s:s + m] = seg[:lt - s]
    pats[rng.random(pats.shape) < 0.01] = 4
    texts[rng.random(texts.shape) < 0.01] = 4
    plens = np.array([min(256, lp), min(257, lp), lp, lp])
    last = (lp - 1) // 256 * 256 + 1  # the last strip's first row
    tlens = np.array([lt, min(lt, plens[1] + band_w + 40),
                      max(min(last - band_w - 3, lt), 0), lt])
    quals = rng.integers(0, 42, (NB, lp))
    return (pats.astype(np.int8), plens.astype(np.int32),
            texts.astype(np.int8), tlens.astype(np.int32),
            quals.astype(np.uint8))
