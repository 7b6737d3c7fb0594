"""Q-gram-seeded mapper (examples/qmap equivalent), in PyTorch.

Port of ``nvbio_tpu/models/qgram_mapper.py``: the read q-grams at a
fixed stride are looked up in a sorted q-gram index of the genome
(``qgram/index.py``, diagonal hits), then the candidates flow through
the flagship's back half (``extend_candidates`` -> K3, ``top2_finish``,
the winners-only traceback -> K2, SAM).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fmindex.index import FMIndex
from ..qgram.index import QGramIndex, build_qgram_index, qgram_filter
from .mapper import Mapper, both_strands, extend_candidates, top2_finish
from .params import MapperParams


def qgram_map_batch(fm: FMIndex, qidx: QGramIndex, gwords, reads, lens,
                    quals, *, q: int, stride: int, max_hits: int,
                    params: MapperParams, genome=None):
    """Forward q-gram mapping step; the output contract of
    ``mapper.map_batch``, with no locate drop and no overflow."""
    if q > 15:
        raise ValueError("q-gram keys are int32 (2 bits/symbol): q <= 15")
    R, L = reads.shape
    n = fm.n
    dev = reads.device
    all_reads, all_quals, lens2 = both_strands(reads, lens, quals)

    # q-grams at a fixed stride (both strands); -1 never matches
    S = max(1, (L - q) // stride + 1)
    offs = torch.arange(S, device=dev) * stride
    win = all_reads[:, offs[:, None] + torch.arange(q, device=dev)]
    bad = (win >= 4).any(dim=-1) | (offs + q > lens2[:, None])
    keys = torch.zeros(win.shape[:2], dtype=torch.int32, device=dev)
    for j in range(q):
        keys = (keys << 2) | (win[:, :, j].to(torch.int32) & 3)
    keys = torch.where(bad, -1, keys)

    diag, valid = qgram_filter(qidx, keys.reshape(-1),
                               offs.expand(2 * R, S).reshape(-1), max_hits)
    SENT = n + 2 * L + 1
    cand = torch.where(valid, diag.to(torch.int64), SENT)
    cand = cand.reshape(2 * R, S * max_hits).clamp(0, SENT)
    cands = extend_candidates(fm, gwords, all_reads, all_quals, lens2, cand,
                              params=params, genome=genome)
    return top2_finish(cands, lens, params)


class QGramMapper(Mapper):
    """The flagship's host orchestration and SAM emit, with q-gram
    seeding; the genome's q-gram index is built once, from the unpadded
    genome."""

    #: escalation re-seeds uniformly, which only the flagship wants
    ESCALATES = False

    def __init__(self, fm, ssa, genome_symbols: np.ndarray, *, q: int = 14,
                 stride: int = 8, max_hits: int = 8, **kw):
        super().__init__(fm, ssa, genome_symbols, **kw)
        self.q = q
        self.stride = stride
        self.max_hits = max_hits
        self.qidx = build_qgram_index(np.asarray(genome_symbols), q=q,
                                      device=self.device)

    def _forward(self, jr, jl, jq, uniform_shift: int = -1, params=None):
        del uniform_shift  # q-gram seeding reverse-complements per row
        return qgram_map_batch(
            self.fm, self.qidx, self.gwords, jr, jl, jq, q=self.q,
            stride=self.stride, max_hits=self.max_hits,
            params=params or self.params, genome=self.genome)
