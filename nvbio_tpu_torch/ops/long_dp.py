"""K4: banded Gotoh DP for long patterns, score-only and with flags.

Port of ``nvbio_tpu/ops/long_dp.py`` (``banded_score_long_pallas``
``:323``, ``banded_directions_long_pallas`` ``:354``, both through
``_long_call``).  The kernel is ``csrc/long_gotoh.cu`` (built by
``_build.py`` at first use): one block per alignment with the band across
its threads, every row in a loop inside the block.

K4's plain versions are ``alignment/batched.py`` ``banded_score_batch``
and ``banded_directions_batch``: the TPU kernel is bit-identical to them
by contract (``long_dp.py:330``), and so is the CUDA kernel.  The wrappers
take them for tensors on the CPU, and only then; for CUDA tensors they
launch the kernel or raise.  ``launch.launches`` counts K4's launches.

Reach follows the JAX package: score-only serves ``band_w <= 971`` (the
row-blocked kernel's VMEM budget at ``row_block = 256``); wider bands go
to the wavefront kernel K5 (``wavefront_dp.wavefront_score``), which
returns raw twin values as it does in the JAX package
(``long_dp.py:336-341``).  Directions serve ``band_w <= 815`` (after the
row-block shrink; the JAX package raises beyond); packed windows serve
``band_w <= 971`` on CUDA and raise beyond (``check_packed``); on the CPU
their plain version serves any band.  The flags come in
the plain version's ``(NB, Lp, 2w+1)`` layout, which ``alignment/walk.py``
takes with ``STRIDE = 2w+1``.
"""

from __future__ import annotations

import torch

from ..alignment.batched import (SCORE_FLOOR, banded_directions_batch,
                                 banded_score_batch)
from ..alignment.types import AlignmentType, GotohScheme, gap_penalties
from . import _build, _launch, wavefront_dp

#: widest band (2 * band_w + 1) the kernel is instantiated for
MAX_BAND = 2048


def _band_fits(band_w: int, row_block: int, with_dirs: bool) -> bool:
    """The JAX kernel's VMEM model at its minimum lane tile
    (``nvbio_tpu/ops/long_dp.py:378``): the reach this port mirrors."""
    band_pad = max(8, (2 * band_w + 1 + 7) // 8 * 8)
    if with_dirs:
        band_pad = (max(32, band_pad) + 31) // 32 * 32
    rb = max(row_block // 8 * 8, 8)
    rows = (7 * band_pad + 3 * rb + band_pad + 8
            + (rb * band_pad // 4 if with_dirs else 0))
    return rows * 128 * 4 <= 8 * 1024 * 1024


def score_reach(band_w: int) -> bool:
    """Whether the JAX package serves score-only at this band with K4
    (and not K5), and packed windows at all."""
    return _band_fits(band_w, 256, with_dirs=False)


def dirs_reach(band_w: int) -> bool:
    """Whether the JAX package serves directions at this band: its row
    block halves from 256 down to 8 until the band fits."""
    row_block = 256
    while row_block > 8 and not _band_fits(band_w, row_block, True):
        row_block //= 2
    return _band_fits(band_w, row_block, True)


def check_long(lp: int, band_w: int, scheme) -> None:
    """The JAX package's sentinel-floor guard (``long_dp.py:391``):
    every reachable score must stay above SCORE_FLOOR."""
    eo, ee, fo, fe = gap_penalties(scheme)
    worst = max(eo, fo) + (lp + 2 * band_w + 1) * max(
        ee, fe, scheme.mismatch_max, scheme.n_penalty, abs(scheme.match))
    if worst >= -SCORE_FLOOR:
        raise ValueError(
            f"scores may cross the sentinel floor (worst={worst}); the "
            "long kernel supports patterns to ~80 kb at default penalties")


def check_reach(lp: int, band_w: int, scheme, with_dirs: bool) -> None:
    """Raise where the JAX package does not serve a long-pattern call
    with K4: ValueError beyond the directions reach or the floor (the
    score-only calls beyond K4's reach go to K5 before this check)."""
    if with_dirs and not dirs_reach(band_w):
        raise ValueError(
            f"band_w={band_w}: the long-read directions kernel serves "
            "band_w <= 815 (nvbio_tpu/ops/long_dp.py raises beyond)")
    check_long(lp, band_w, scheme)


def check_packed(band_w: int) -> None:
    """The packed-window variant has no wavefront dispatch in the JAX
    package: its VMEM guard raises beyond the row-blocked reach."""
    if not score_reach(band_w):
        raise ValueError(
            f"band_w={band_w}: packed windows are served to band_w <= 971 "
            "(nvbio_tpu/ops/banded_dp.py's VMEM guard raises beyond)")


def launch(patterns, plens, tlens, quals=None, *, texts=None, packed=None,
           win_start=None, with_dirs: bool = False, scheme: GotohScheme,
           atype: AlignmentType, band_w: int):
    """Launch K4 on CUDA inputs: over symbol windows ``texts`` (NB, Lt),
    or, score-only, over windows ``[win_start, win_start + tlen)`` of the
    2-bit ``packed`` genome.  Returns the result dict, and with
    ``with_dirs`` also dirs (NB, Lp, 2 * band_w + 1) uint8."""
    if band_w < 0 or 2 * band_w + 1 > MAX_BAND:
        raise ValueError(
            f"band_w={band_w}: the K4 kernel is instantiated for bands up "
            f"to {MAX_BAND} cells (band_w <= {(MAX_BAND - 1) // 2})")
    pats, qual, pl, tl, out = _launch.stage_inputs(patterns, plens, tlens,
                                                   quals)
    nb, lp = pats.shape
    sargs = _launch.scheme_args(scheme, atype)
    stream = _launch.stream(pats.device)
    lib = _build.library()
    dirs = None
    if packed is not None:
        gw, ws = _launch.stage_packed(packed, win_start, nb)
        name = "k4_long_score_packed"
        rc = lib.k4_long_score_packed(
            pats.data_ptr(), qual.data_ptr(), pl.data_ptr(), gw.data_ptr(),
            gw.numel(), ws.data_ptr(), tl.data_ptr(), nb, lp, band_w, *sargs,
            out.data_ptr(), stream)
    else:
        tx = _launch.stage_texts(texts, nb)
        args = (pats.data_ptr(), qual.data_ptr(), pl.data_ptr(),
                tx.data_ptr(), tl.data_ptr(), nb, lp, tx.shape[1], band_w,
                *sargs, out.data_ptr())
        if with_dirs:
            dirs = torch.empty((nb, lp, 2 * band_w + 1), dtype=torch.uint8,
                               device=pats.device)
            name = "k4_long_directions"
            rc = lib.k4_long_directions(*args, dirs.data_ptr(), stream)
        else:
            name = "k4_long_score"
            rc = lib.k4_long_score(*args, stream)
    _build.check(lib, rc, name)
    launch.launches += 1
    res = _launch.result(out)
    return (res, dirs) if with_dirs else res


launch.launches = 0


def banded_score_long(patterns, plens, texts, tlens, quals=None, *,
                      scheme: GotohScheme, atype: AlignmentType,
                      band_w: int):
    """K4 score-only: banded Gotoh score + sink of long patterns over
    symbol windows.  patterns (NB, Lp); texts (NB, Lt); plens, tlens
    (NB,); quals (NB, Lp) or None (= 40).  Returns dict of (NB,) int32
    ``score``, ``p_end``, ``t_end``.  Bands beyond K4's reach go to K5
    (raw twin values, as in the JAX package)."""
    if not score_reach(band_w):
        return wavefront_dp.wavefront_score(patterns, plens, texts, tlens,
                                            quals, scheme=scheme, atype=atype,
                                            band_w=band_w)
    check_reach(patterns.shape[1], band_w, scheme, with_dirs=False)
    if _launch.on_cpu(patterns, plens, texts, tlens, quals):
        return banded_score_batch(patterns, plens, texts, tlens, quals,
                                  scheme=scheme, atype=atype, band_w=band_w)
    return launch(patterns, plens, tlens, quals, texts=texts, scheme=scheme,
                  atype=atype, band_w=band_w)


def banded_directions_long(patterns, plens, texts, tlens, quals=None, *,
                           scheme: GotohScheme, atype: AlignmentType,
                           band_w: int):
    """K4 with flags.  Returns (result dict, dirs (NB, Lp, 2 * band_w + 1)
    uint8)."""
    check_reach(patterns.shape[1], band_w, scheme, with_dirs=True)
    if _launch.on_cpu(patterns, plens, texts, tlens, quals):
        return banded_directions_batch(patterns, plens, texts, tlens, quals,
                                       scheme=scheme, atype=atype,
                                       band_w=band_w)
    return launch(patterns, plens, tlens, quals, texts=texts,
                  with_dirs=True, scheme=scheme, atype=atype, band_w=band_w)
