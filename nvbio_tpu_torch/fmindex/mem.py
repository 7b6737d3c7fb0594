"""Maximal exact match (MEM/SMEM) search over the FM-index, in PyTorch.

Port of ``nvbio_tpu/fmindex/mem.py`` (``find_mems``), the seeding engine
of the MEM mapper ("nvMem").  For every end position e of every read,
one loop over match length extends backward through the FM-index and
records the longest non-empty extension (the left-maximal match ending
at e, capped at ``max_len``).  A match is an SMEM iff it is not
contained in the (necessarily longer) match ending at e + 1: containment
by any farther end implies containment at e + 1.

The loop runs ``max_len`` steps of batched tensor ops and never syncs
with the host; lo and hi go through one ``rank`` call a step, stacked.
"""

from __future__ import annotations

import torch

from .index import FMIndex, rank

#: the symbol of the lanes before a read's start (no match extends there)
PADV = 7


def find_mems(fm: FMIndex, reads, lens, max_len: int, min_len: int = 19):
    """reads: (R, L) symbols; lens: (R,).

    Returns a dict of (R, L) tensors indexed by end position e - 1:
      ``len``  - longest match ending at e (backward/left-maximal),
      ``lo``/``hi`` - its SA range (int64),
      ``smem`` - True where the match is an SMEM with len >= min_len.
    """
    R, L = reads.shape
    dev = reads.device
    reads_pad = torch.nn.functional.pad(reads.to(torch.int64), (max_len, 0),
                                        value=PADV)
    # lohi[0] = lo, lohi[1] = hi of every (row, end) lane
    lohi = torch.stack([torch.zeros((R, L), dtype=torch.int64, device=dev),
                        torch.full((R, L), fm.n + 1, dtype=torch.int64,
                                   device=dev)])
    alive = torch.ones((R, L), dtype=torch.bool, device=dev)
    blen = torch.zeros((R, L), dtype=torch.int64, device=dev)
    blohi = torch.zeros_like(lohi)
    for k in range(1, max_len + 1):
        # the symbol at read index e - k of end e = j + 1
        c = reads_pad[:, max_len - k + 1: max_len - k + 1 + L]
        bad = c >= 4
        c4 = c.clamp(max=3)
        nlohi = fm.C[c4] + rank(fm, c4.expand(2, R, L), lohi)
        alive = alive & ~bad & (nlohi[0] < nlohi[1])
        lohi = torch.where(alive, nlohi, lohi)
        blen = torch.where(alive, k, blen)
        blohi = torch.where(alive, lohi, blohi)
    ends = torch.arange(1, L + 1, device=dev)[None, :]
    lens = lens.to(torch.int64)[:, None]
    in_read = ends <= lens
    # SMEM: not contained in the match ending one position later
    next_len = torch.nn.functional.pad(blen[:, 1:], (0, 1), value=0)
    smem = in_read & (blen >= min_len) & ((ends == lens) | (next_len <= blen))
    return {"len": blen, "lo": blohi[0], "hi": blohi[1], "smem": smem}
