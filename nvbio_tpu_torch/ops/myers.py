"""K6: Myers bit-vector edit distance, GLOBAL and SEMI_GLOBAL.

Port of ``nvbio_tpu/ops/myers_pallas.py`` (``myers_pallas`` ``:187``).
The kernel is ``csrc/myers.cu`` (built by ``_build.py`` at first use):
one thread per alignment, the bit-vector words in registers up to 8
words (256 bp), in device scratch beyond.  Its plain version is
``alignment/myers.py`` ``myers_edit_distance_batch``; the wrapper takes it
for tensors on the CPU, and only then.  For CUDA tensors it launches the
kernel or raises.  ``myers.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from ..alignment.myers import myers_edit_distance_batch
from ..alignment.types import AlignmentType
from . import _build, _launch


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
    lib = _build.library()
    scratch = torch.empty(max(lib.k6_scratch_words(nb, lp), 1),
                          dtype=torch.int32, device=dev)
    out = torch.empty((2, nb), dtype=torch.int32, device=dev)
    rc = lib.k6_myers(pats.data_ptr(), pl.data_ptr(), tx.data_ptr(),
                      tl.data_ptr(), nb, lp, tx.shape[1],
                      int(atype == AlignmentType.GLOBAL), scratch.data_ptr(),
                      out.data_ptr(), _launch.stream(dev))
    _build.check(lib, rc, "k6_myers")
    myers.launches += 1
    return out[0], out[1]


myers.launches = 0
