"""MEM-seeded mapper ("nvMem" equivalent), in PyTorch.

Port of ``nvbio_tpu/models/mem_mapper.py``:

    SMEM search (fmindex/mem.py) -> top-K SMEMs by length -> SA-interval
    expansion + locate -> diagonal dedupe + banded Gotoh extension (K3)
    -> top-2 reduce -> MAPQ -> winners-only traceback (K2) -> SAM

The back half (extension, reduce, traceback, SAM) is the flagship
mapper's (models/mapper.py); only the seeding differs.  Collinear SMEMs
land on one diagonal and are extended once.
"""

from __future__ import annotations

import torch

from ..fmindex.index import FMIndex, SSA, locate
from ..fmindex.mem import find_mems
from .mapper import Mapper, both_strands, extend_candidates, top2_finish
from .params import MapperParams


def mem_map_batch(fm: FMIndex, ssa: SSA, gwords, reads, lens, quals, *,
                  params: MapperParams, genome=None):
    """Forward MEM-mapping step; the output contract of
    ``mapper.map_batch`` (per-read best/second/strand/mapq), with no
    locate drop and no overflow."""
    R, L = reads.shape
    K = params.max_smems
    CAP = params.max_hits_per_seed
    n = fm.n
    dev = reads.device

    all_reads, all_quals, lens2 = both_strands(reads, lens, quals)
    mems = find_mems(fm, all_reads, lens2, max_len=L,
                     min_len=params.min_mem_len)

    # top-K SMEMs per read-strand by match length (stable: the first of
    # equal lengths win, as jnp.argsort)
    val = torch.where(mems["smem"], mems["len"], -1)
    order = torch.argsort(-val, dim=1, stable=True)[:, :K]  # end indices

    def take(a):
        return torch.gather(a, 1, order)

    k_len, k_lo, k_hi = take(mems["len"]), take(mems["lo"]), take(mems["hi"])
    k_ok = take(val) > 0
    sizes = torch.where(k_ok, k_hi - k_lo, 0)
    use = torch.where(sizes > params.max_range, 0, sizes.clamp(max=CAP))

    # SA-interval expansion + locate of every row
    t = torch.arange(CAP, device=dev)
    rows = k_lo[:, :, None] + t  # (2R, K, CAP)
    hit_ok = t < use[:, :, None]
    pos = locate(fm, ssa, rows.clamp(0, n).reshape(-1),
                 k_sample=params.sa_sample).reshape(2 * R, K, CAP)

    # candidate window start = hit position - read offset of the SMEM,
    # which spans [e - len, e) with e = order + 1
    start_in_read = order + 1 - k_len
    SENT = n + 2 * L + 1
    cand = torch.where(hit_ok, pos - start_in_read[:, :, None], SENT)
    cand = cand.clamp(min=0)
    cands = extend_candidates(fm, gwords, all_reads, all_quals, lens2,
                              cand.reshape(2 * R, K * CAP), params=params,
                              genome=genome)
    return top2_finish(cands, lens, params)


class MemMapper(Mapper):
    """The flagship's host orchestration and SAM emit, with MEM seeding
    in the forward step."""

    #: escalation re-seeds uniformly, which only the flagship wants
    ESCALATES = False

    def _forward(self, jr, jl, jq, uniform_shift: int = -1, params=None):
        del uniform_shift  # MEM seeding reverse-complements per row
        return mem_map_batch(self.fm, self.ssa, self.gwords, jr, jl, jq,
                             params=params or self.params,
                             genome=self.genome)
