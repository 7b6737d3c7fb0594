"""K7's live band (``ops.banded_dp.k7_live_range``): the cells the CUDA
kernel computes hold every cell the plain version
(``alignment.batched.banded_score_batch16``) ever marks valid, at
seeded shapes inside the int16 guard, and the range is no wider than
the band.  The kernel itself is held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from nvbio_tpu_torch.alignment.batched import band16_rows, band_pad
from nvbio_tpu_torch.alignment.types import GotohScheme
from nvbio_tpu_torch.ops import banded_dp

#: the widest live band K7's tiers hold (csrc/banded_gotoh16.cu with_tier)
K7_MAX_CELLS = 768


def _shapes(n, seed=19):
    """n seeded (Lp, band_w) pairs inside int16_ok for the default
    scheme: Lp8 a multiple of 16 up to 512, band_w up to the guard."""
    rng = np.random.default_rng(seed)
    s, out = GotohScheme(), []
    while len(out) < n:
        lp = int(rng.integers(1, 33)) * 16 - int(rng.integers(0, 8))
        wmax = max((w for w in range(0, 800)
                    if banded_dp.int16_ok(lp, w, s)), default=None)
        if wmax is None:
            continue
        out.append((lp, int(rng.integers(0, wmax + 1))))
    return out


def _valid_cells(lp, band_w, plens, tlens):
    """The band cells k the plain version marks valid in some row, from
    the rows it runs (``alignment.batched.band16_rows``)."""
    seen = torch.zeros(band_pad(2 * band_w + 1), dtype=torch.bool)
    for _, valid in band16_rows(torch.from_numpy(plens),
                                torch.from_numpy(tlens), lp, band_w):
        seen |= valid.any(0)
    return np.flatnonzero(seen.numpy())


@pytest.mark.parametrize("lp,band_w", _shapes(20))
def test_live_range_holds_every_valid_cell(lp, band_w):
    k_lo, n = banded_dp.k7_live_range(lp, band_w)
    band = 2 * band_w + 1
    assert 1 <= n <= band and k_lo + n - 1 == 2 * band_w
    rng = np.random.default_rng(lp * 1000 + band_w)
    lt = lp + 2 * band_w
    plens = rng.integers(0, lp + 1, 64)
    plens[0] = (lp + 7) // 8 * 8  # rows to Lp8 (past lp: PAD rows)
    tlens = rng.integers(0, lt + 40, 64)  # tlen may pass Lt
    tlens[0] = lt + 40
    cells = _valid_cells(lp, band_w, plens, tlens)
    assert cells.min() >= k_lo and cells.max() <= 2 * band_w
    # no wider than it must be: lane 0 reaches both ends of the range
    assert cells.min() == k_lo and cells.max() == 2 * band_w


def test_live_range_fits_the_widest_tier():
    """The guard's widest live band (Lp8 16, band_w 719: 736 cells) fits
    K7's widest tier; with no rows one cell."""
    s = GotohScheme()
    widest = 0
    for lp8 in range(16, 513, 16):
        w = max(w for w in range(0, 800) if banded_dp.int16_ok(lp8, w, s))
        widest = max(widest, banded_dp.k7_live_range(lp8, w)[1])
    assert widest == 736 <= K7_MAX_CELLS
    assert banded_dp.k7_live_range(16, 719) == (703, 736)
    assert banded_dp.k7_live_range(128, 15) == (0, 31)
    assert banded_dp.k7_live_range(16, 700) == (684, 717)
    assert banded_dp.k7_live_range(0, 5) == (10, 1)
