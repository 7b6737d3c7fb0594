"""Generic-alphabet FM-index over a wavelet-tree rank dictionary.

Port of ``nvbio_tpu/fmindex/wavelet_fm.py`` (ref: nvbio/fmindex/
fmindex.h instantiated with the wavelet-tree rank dictionary,
strings/wavelet_tree.h) — the reference's protein FM-index
configuration.  The DNA path keeps its 2-bit popcount layout
(``fmindex/index.py``); this module covers alphabets up to 32 symbols
(protein = 22).

Same sentinel convention as the DNA index: the BWT row of the sentinel
holds a dummy symbol 0, ``rank`` subtracts it, C[c] counts the sentinel
once.  The build is host work (native SA-IS through ``sufsort.sa``);
the backward search is a Python loop over the seed positions (the
reference's ``lax.scan``) of batched torch gathers, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..strings.wavelet import WaveletTree, build_wavelet_tree, wt_rank
from ..sufsort.sa import bwt_from_sa, suffix_array


class WaveletFMIndex(NamedTuple):
    wt: WaveletTree
    C: torch.Tensor  # (sigma + 1,) int64
    primary: int
    n: int
    sigma: int


def build_wavelet_fm_index(text: np.ndarray, sigma: int,
                           device="cpu") -> WaveletFMIndex:
    """Build for `text` (uint8 symbols in [0, sigma)); the index's
    tensors on ``device``."""
    text = np.asarray(text, dtype=np.uint8)
    if text.size and int(text.max()) >= sigma:
        raise ValueError("symbol out of range for sigma")
    n = len(text)
    sa = suffix_array(text)
    bwt, primary = bwt_from_sa(text, sa)
    wt = build_wavelet_tree(bwt.astype(np.int32), sigma, device)
    counts = np.bincount(text, minlength=sigma)
    C = np.zeros(sigma + 1, dtype=np.int64)
    C[0] = 1  # sentinel
    C[1:] = 1 + np.cumsum(counts)
    return WaveletFMIndex(wt=wt, C=torch.from_numpy(C).to(device),
                          primary=int(primary), n=n, sigma=sigma)


def wfm_rank(fm: WaveletFMIndex, c, i):
    """occ(c, i) excluding the sentinel's dummy-0 slot."""
    cnt = wt_rank(fm.wt, c, i)
    return cnt - ((c == 0) & (i > fm.primary)).to(torch.int64)


def wfm_backward_search(fm: WaveletFMIndex, seeds, slens=None):
    """Batched exact backward search, generic alphabet.

    seeds: (N, L) integer symbols in [0, sigma) (others give an empty
    range); slens: effective lengths (None = L).  Returns int64 (lo, hi)
    SA ranges."""
    seeds = seeds.to(torch.int64)
    N, L = seeds.shape
    dev = seeds.device
    if slens is None:
        slens = torch.full((N,), L, dtype=torch.int64, device=dev)
    lo = torch.zeros(N, dtype=torch.int64, device=dev)
    hi = torch.full((N,), fm.n + 1, dtype=torch.int64, device=dev)
    for pos in range(L - 1, -1, -1):
        c = seeds[:, pos]
        active = pos < slens
        bad = (c < 0) | (c >= fm.sigma)
        c_ = c.clamp(0, fm.sigma - 1)
        nlo = torch.where(bad, 0, fm.C[c_] + wfm_rank(fm, c_, lo))
        nhi = torch.where(bad, 0, fm.C[c_] + wfm_rank(fm, c_, hi))
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
    return lo, hi
