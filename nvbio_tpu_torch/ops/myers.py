"""K6: Myers bit-vector edit distance, GLOBAL and SEMI_GLOBAL.

Port of ``nvbio_tpu/ops/myers_pallas.py`` (``myers_pallas`` ``:187``).
The kernel is ``csrc/myers.cu`` (built by ``_build.py`` at first use),
in two tiers that ``myers_plan`` gives by the words W = ceil(Lp / 32):
one thread an alignment with its words in registers up to 8 words (256
bp), and beyond, the words of an alignment across the lanes of S warps
(strips), K words a lane, the carry between lanes by ballots.  The C
entry ``k6_plan`` decides the tier (``myers_plan`` is its mirror, for the
tests); the launch writes the tier it took into a host int.  Its plain
version is ``alignment/myers.py`` ``myers_edit_distance_batch``; the
wrapper takes it for tensors on the CPU, and only then.  For CUDA tensors
it launches the kernel or raises.  ``myers.launches`` counts the
launches, ``myers.warp_launches`` those on the warp tier.
"""

from __future__ import annotations

import ctypes

import torch

from ..alignment.myers import myers_edit_distance_batch
from ..alignment.types import AlignmentType
from . import _launch

#: the kernel's tiers, as ``myers_plan`` gives them
THREAD, WARP = 0, 1
#: widest pattern (in 32-bit words) of the thread tier
MAX_REG_WORDS = 8
#: the warp tier's words a lane K, each with the strips a block holds at
#: most: one warp an alignment to 32 words, up to 8 strips of 2 words a
#: lane, then 8 words a lane (18 strips reach the JAX guard's 4 520
#: words); K and strips chosen by turns on an H100 (PERF.md)
WARP_STRIPS = {1: 1, 2: 8, 8: 18}


def myers_plan(lp: int):
    """``(tier, words a lane, strips)`` of a K6 call at Lp on CUDA, as
    ``csrc/myers.cu`` ``plan_of`` (C entry ``k6_plan``) decides it: W <=
    MAX_REG_WORDS the thread tier ``(THREAD, 0, 0)``; beyond, the warp
    tier at the smallest K of WARP_STRIPS whose S = ceil(W / 32 K) strips
    fit a block.  Raises ValueError past the widest reach."""
    words = -(-lp // 32)
    if words <= MAX_REG_WORDS:
        return THREAD, 0, 0
    for k, smax in WARP_STRIPS.items():
        s = -(-words // (32 * k))
        if s <= smax:
            return WARP, k, s
    raise ValueError(f"Lp={lp}: past the warp tier's reach "
                     f"({32 * 8 * WARP_STRIPS[8]} words)")


def check_myers(lp: int, atype: AlignmentType) -> None:
    """Raise where the JAX package does not serve a Myers call: LOCAL, and
    patterns whose working set exceeds its VMEM guard even at the
    smallest lane tile (``myers_pallas.py:199-217``)."""
    if atype == AlignmentType.LOCAL:
        raise ValueError("Myers aligner is GLOBAL/SEMI_GLOBAL only")
    w_pad = max(8, (-(-lp // 32) + 7) // 8 * 8)
    rows = 18 * w_pad + 512 + 16
    if rows * 32 * 4 > 10 * 1024 * 1024:
        raise ValueError(
            f"myers working set {rows * 32 * 4 / 2**20:.1f} MiB > 10 MiB "
            f"even at tile=32 (Lp={lp}); use the banded Gotoh engines for "
            "patterns this long")


def myers(patterns, plens, texts, tlens, *,
          atype: AlignmentType = AlignmentType.SEMI_GLOBAL):
    """K6: bit-vector edit distance of each pattern against its text.

    patterns (NB, Lp) symbols (>= 4 never match); plens (NB,); texts
    (NB, Lt); tlens (NB,).  Returns (distance, t_end) int32 (NB,), as
    ``myers_edit_distance_batch``."""
    check_myers(patterns.shape[1], atype)
    if _launch.on_cpu(patterns, plens, texts, tlens):
        return myers_edit_distance_batch(patterns, plens, texts, tlens,
                                         atype=atype)
    nb, lp = patterns.shape
    if plens.shape != (nb,) or tlens.shape != (nb,):
        raise ValueError("plens and tlens must be (NB,)")
    tx = _launch.stage_texts(texts, nb)
    pats = patterns.to(torch.int8).contiguous()
    pl = plens.to(torch.int32).contiguous()
    tl = tlens.to(torch.int32).contiguous()
    dev = pats.device
    out = torch.empty((2, nb), dtype=torch.int32, device=dev)
    tier = ctypes.c_int(-1)  # the tier the launch took
    _launch.call("k6_myers", dev, pats.data_ptr(), pl.data_ptr(),
                 tx.data_ptr(), tl.data_ptr(), nb, lp, tx.shape[1],
                 int(atype == AlignmentType.GLOBAL), out.data_ptr(),
                 ctypes.addressof(tier))
    myers.launches += 1
    if tier.value == WARP:
        myers.warp_launches += 1
    return out[0], out[1]


myers.launches = 0
myers.warp_launches = 0
