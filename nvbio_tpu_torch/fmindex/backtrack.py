"""Approximate (<= 1 substitution) seed search over the FM-index.

Port of ``nvbio_tpu/fmindex/backtrack.py:31`` (``hamming_backtrack_1``),
the search behind ``-N 1`` seeding.  The reference replaces NVBIO's
per-thread DFS stack with a wavefront of every branch at once: one exact
right-to-left pass records the SA range of every seed suffix, then a
second pass walks the positions right-to-left carrying every (position
p, substitute b) branch; branch (p, b) is born at step p from the stored
suffix range, extended by b, and afterwards follows the exact symbols.

Both passes are XLA scans there, not Pallas kernels; here they are a
Python loop over the L positions of plain torch ops on the device of the
index tensors, over the port's ``rank``.
"""

from __future__ import annotations

import torch

from .index import FMIndex, rank


def hamming_backtrack_1(fm: FMIndex, seeds, slens=None):
    """All exact and 1-substitution SA ranges of each seed.

    seeds: (N, L) symbols, left-aligned; slens: (N,) effective lengths
    (None = L).  Returns dict of int64 tensors (``valid`` bool):
      exact_lo/exact_hi (N,): the exact-match range;
      lo/hi (N, L, 4): the range of the seed with position p substituted
        by base b;
      valid (N, L, 4): p < slen, b != seed[p], the range is not empty,
        and the seed has no N inside.
    """
    seeds = seeds.to(torch.int64)
    N, L = seeds.shape
    dev = seeds.device
    slens = (torch.full((N,), L, dtype=torch.int64, device=dev)
             if slens is None else slens.to(torch.int64))
    n1 = fm.n + 1

    def lf(c, lo, hi):
        return fm.C[c] + rank(fm, c, lo), fm.C[c] + rank(fm, c, hi)

    # pass 1: exact suffix ranges, right to left; start_lo/hi[pos] is the
    # range of seed[pos + 1:] (the whole index for pos = L - 1)
    lo = torch.zeros(N, dtype=torch.int64, device=dev)
    hi = torch.full((N,), n1, dtype=torch.int64, device=dev)
    start_lo = [None] * L
    start_hi = [None] * L
    for pos in range(L - 1, -1, -1):
        start_lo[pos], start_hi[pos] = lo, hi
        c = seeds[:, pos]
        bad = c >= 4
        nlo, nhi = lf(c.clamp(max=3), lo, hi)
        active = pos < slens
        lo = torch.where(active, torch.where(bad, 0, nlo), lo)
        hi = torch.where(active, torch.where(bad, 0, nhi), hi)
    elo, ehi = lo, hi

    # pass 2: every (p, b) branch in one wavefront
    bases = torch.arange(4, dtype=torch.int64, device=dev)[None, None, :]
    p_idx = torch.arange(L, dtype=torch.int64, device=dev)[None, :, None]
    sl = slens[:, None, None]
    blo = torch.zeros((N, L, 4), dtype=torch.int64, device=dev)
    bhi = torch.zeros((N, L, 4), dtype=torch.int64, device=dev)
    for pos in range(L - 1, -1, -1):
        # branches born here: b substituted for seed[pos]
        born_lo, born_hi = lf(bases, start_lo[pos][:, None, None],
                              start_hi[pos][:, None, None])  # (N, 1, 4)
        # branches already alive (p > pos) extend by the exact symbol
        c = seeds[:, pos][:, None, None]
        bad = c >= 4
        ext_lo, ext_hi = lf(c.clamp(max=3).expand(N, L, 4), blo, bhi)
        ext_lo = torch.where(bad, 0, ext_lo)
        ext_hi = torch.where(bad, 0, ext_hi)
        is_born = p_idx == pos
        alive = p_idx > pos
        nlo = torch.where(is_born, born_lo, torch.where(alive, ext_lo, blo))
        nhi = torch.where(is_born, born_hi, torch.where(alive, ext_hi, bhi))
        # positions beyond the seed length stay frozen
        in_seed = (p_idx < sl) & (pos < sl)
        blo = torch.where(in_seed, nlo, blo)
        bhi = torch.where(in_seed, nhi, bhi)

    in_len = torch.arange(L, device=dev)[None, :] < slens[:, None]
    has_n = (torch.where(in_len, seeds, 0) >= 4).any(dim=1)
    valid = ((p_idx < sl) & (bases != seeds[:, :, None]) & (bhi > blo)
             & ~has_n[:, None, None])
    return {"exact_lo": elo, "exact_hi": ehi, "lo": blo, "hi": bhi,
            "valid": valid}
