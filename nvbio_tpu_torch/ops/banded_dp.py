"""Wrappers for the banded Gotoh CUDA kernels, and their plain versions.

Port of ``nvbio_tpu/ops/banded_dp.py``.  Three kernels, all in
``csrc/banded_gotoh.cu`` (built by ``_build.py`` at first use):

- K1 ``banded_score``: score + sink over symbol windows
  (replaces ``banded_score_pallas``, ``banded_dp.py:761``);
- K3 ``banded_score_packed``: the same over windows of the 2-bit packed
  genome, the mapper's extension scorer (replaces
  ``banded_score_pallas_packed``, ``banded_dp.py:528``);
- K2 ``banded_directions``: score + sink + per-cell traceback flags in
  the plain version's ``(R, Lp, 2w+1)`` layout, the mapper's traceback
  DP (replaces ``banded_directions_pallas``, ``banded_dp.py:620``).

``route()`` picks the kernel for a call's shape: patterns longer than
LONG_THRESHOLD go to K4 (``long_dp.py``, ``csrc/long_gotoh.cu``), as in
the JAX package, and so do bands wider than K1-K3's register capacity
(MAX_BAND cells), with identical outputs.

Each wrapper takes its plain PyTorch version (``alignment/batched.py``)
for tensors on the CPU, and only then.  For CUDA tensors it launches the
kernel or raises; nothing falls back.  Each kernel counts its launches
in the ``launches`` attribute of its entry in KERNELS.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alignment.batched import (PAD_SYMBOL, banded_directions_batch,
                                 banded_score_batch)
from ..alignment.types import AlignmentType, GotohScheme
from . import _build, _launch, long_dp, myers, wavefront_dp

#: widest band (2 * band_w + 1) K1-K3 are instantiated for; wider bands
#: go to K4's band-parallel kernel
MAX_BAND = 64
#: patterns longer than this go to K4 (``nvbio_tpu/ops/banded_dp.py:48``)
LONG_THRESHOLD = 512
#: tail words appended by pack_genome_words so window reads past the
#: genome end stay inside the array
PACK_TAIL_WORDS = 256


def pack_genome_words(symbols, device="cpu") -> torch.Tensor:
    """2-bit pack genome symbols (values 0..3; N already substituted at
    build time) into int32 words, 16 symbols each, LSB first, plus
    PACK_TAIL_WORDS zero words (``nvbio_tpu`` ``banded_dp.py:715``)."""
    s = np.asarray(symbols)
    n = s.shape[0]
    if n and int(s.max()) >= 4:
        raise ValueError(
            "pack_genome_words: genome contains N/ambiguity symbols (>= 4);"
            " packed 2-bit extension would silently score them as G, "
            "diverging from the unpacked path's n_penalty.  Substitute N "
            "at build time (tools/build_index.py does this) before packing.")
    nw = (n + 15) // 16
    s16 = np.zeros(nw * 16, np.uint32)
    s16[:n] = s.astype(np.uint32)
    s16 = s16.reshape(nw, 16)
    w = np.zeros(nw + PACK_TAIL_WORDS, np.uint32)
    for r in range(16):
        w[:nw] |= s16[:, r] << np.uint32(2 * r)
    return torch.from_numpy(w.view(np.int32)).to(device)


def window_slices(arr: torch.Tensor, starts: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Per-lane windows ``arr[s : s + width]``, starts clamped to
    ``[0, len - width]`` (the clamp of ``jax.lax.dynamic_slice``)."""
    s = starts.to(torch.int64).clamp(0, max(arr.shape[0] - width, 0))
    return arr[s[:, None] + torch.arange(width, device=arr.device)]


def unpack_windows(packed: torch.Tensor, win_start: torch.Tensor,
                   tlens: torch.Tensor, width: int) -> torch.Tensor:
    """Symbol windows of the packed genome: (NB, width) int8 with PAD
    from each lane's tlen on (what K3 reads in-kernel)."""
    m = torch.arange(width, device=packed.device)
    idx = win_start.to(torch.int64)[:, None] + m
    word = packed[(idx >> 4).clamp(max=packed.shape[0] - 1)].to(torch.int64)
    sym = (word >> (2 * (idx & 15))) & 3
    return torch.where(m[None, :] < tlens.to(torch.int64)[:, None], sym,
                       PAD_SYMBOL).to(torch.int8)


def banded_score_packed_plain(patterns, plens, packed, win_start, tlens,
                              quals=None, *, scheme: GotohScheme,
                              atype: AlignmentType, band_w: int):
    """K3's plain version: unpack the windows, then the plain K1."""
    texts = unpack_windows(packed, win_start, tlens,
                           patterns.shape[1] + 2 * band_w)
    return banded_score_batch(patterns, plens, texts, tlens, quals,
                              scheme=scheme, atype=atype, band_w=band_w)


_on_cpu = _launch.on_cpu


def _launch_inputs(patterns, plens, tlens, quals, band_w):
    if 2 * band_w + 1 > MAX_BAND or band_w < 0:
        raise ValueError(
            f"band_w={band_w}: K1-K3 are instantiated for bands up to "
            f"{MAX_BAND} cells (band_w <= {(MAX_BAND - 1) // 2}); route() "
            "sends wider bands to K4")
    return _launch.stage_inputs(patterns, plens, tlens, quals)


def route(lp: int, band_w: int, with_dirs: bool, packed: bool = False) -> str:
    """The kernel a call of this shape launches on a CUDA device: K4 for
    patterns longer than LONG_THRESHOLD (the JAX package's dispatch) and
    for bands wider than K1-K3's register capacity (MAX_BAND cells);
    otherwise K2 with flags, K3 over packed windows, K1."""
    if lp > LONG_THRESHOLD or 2 * band_w + 1 > MAX_BAND:
        return "K4"
    return "K2" if with_dirs else ("K3" if packed else "K1")


def banded_score(patterns, plens, texts, tlens, quals=None, *,
                 scheme: GotohScheme, atype: AlignmentType, band_w: int):
    """K1: banded Gotoh score + sink over symbol windows.

    patterns (NB, Lp) symbols; texts (NB, Lt); plens, tlens (NB,);
    quals (NB, Lp) or None (= 40).  Returns dict of (NB,) int32
    ``score``, ``p_end``, ``t_end``.  Patterns beyond LONG_THRESHOLD
    rows go to K4 (``long_dp.banded_score_long``), and so do wide bands
    on CUDA."""
    kernel = route(patterns.shape[1], band_w, with_dirs=False)
    if patterns.shape[1] > LONG_THRESHOLD:
        return long_dp.banded_score_long(patterns, plens, texts, tlens, quals,
                                         scheme=scheme, atype=atype,
                                         band_w=band_w)
    if _on_cpu(patterns, plens, texts, tlens, quals):
        return banded_score_batch(patterns, plens, texts, tlens, quals,
                                  scheme=scheme, atype=atype, band_w=band_w)
    if kernel == "K4":
        return long_dp.launch(patterns, plens, tlens, quals, texts=texts,
                              scheme=scheme, atype=atype, band_w=band_w)
    pats, qual, pl, tl, out = _launch_inputs(patterns, plens, tlens, quals,
                                             band_w)
    tx = _launch.stage_texts(texts, pats.shape[0])
    lib = _build.library()
    rc = lib.k1_banded_score(
        pats.data_ptr(), qual.data_ptr(), pl.data_ptr(), tx.data_ptr(),
        tl.data_ptr(), pats.shape[0], pats.shape[1], tx.shape[1], band_w,
        *_launch.scheme_args(scheme, atype), out.data_ptr(),
        _launch.stream(pats.device))
    _build.check(lib, rc, "k1_banded_score")
    banded_score.launches += 1
    return _launch.result(out)


def banded_score_packed(patterns, plens, packed, win_start, tlens,
                        quals=None, *, scheme: GotohScheme,
                        atype: AlignmentType, band_w: int):
    """K3: banded Gotoh score + sink over windows ``[win_start,
    win_start + tlen)`` of the 2-bit packed genome (pack_genome_words).
    Bit-identical to K1 over the unpacked windows.  Long patterns and
    wide bands go to K4's packed variant on CUDA."""
    kernel = route(patterns.shape[1], band_w, with_dirs=False, packed=True)
    if _on_cpu(patterns, plens, packed, win_start, tlens, quals):
        return banded_score_packed_plain(
            patterns, plens, packed, win_start, tlens, quals,
            scheme=scheme, atype=atype, band_w=band_w)
    long_dp.check_packed(band_w)
    if kernel == "K4":
        return long_dp.launch(patterns, plens, tlens, quals, packed=packed,
                              win_start=win_start, scheme=scheme,
                              atype=atype, band_w=band_w)
    pats, qual, pl, tl, out = _launch_inputs(patterns, plens, tlens, quals,
                                             band_w)
    gw, ws = _launch.stage_packed(packed, win_start, pats.shape[0])
    lib = _build.library()
    rc = lib.k3_banded_score_packed(
        pats.data_ptr(), qual.data_ptr(), pl.data_ptr(), gw.data_ptr(),
        gw.numel(), ws.data_ptr(), tl.data_ptr(), pats.shape[0],
        pats.shape[1], band_w, *_launch.scheme_args(scheme, atype),
        out.data_ptr(), _launch.stream(pats.device))
    _build.check(lib, rc, "k3_banded_score_packed")
    banded_score_packed.launches += 1
    return _launch.result(out)


def banded_directions(patterns, plens, texts, tlens, quals=None, *,
                      scheme: GotohScheme, atype: AlignmentType,
                      band_w: int):
    """K2: K1 plus one traceback flag per band cell.

    Returns (result dict, dirs (NB, Lp, 2 * band_w + 1) uint8).  Patterns
    beyond LONG_THRESHOLD rows go to K4 (``long_dp.banded_directions_long``),
    and so do wide bands on CUDA."""
    kernel = route(patterns.shape[1], band_w, with_dirs=True)
    if patterns.shape[1] > LONG_THRESHOLD:
        return long_dp.banded_directions_long(
            patterns, plens, texts, tlens, quals, scheme=scheme, atype=atype,
            band_w=band_w)
    if _on_cpu(patterns, plens, texts, tlens, quals):
        return banded_directions_batch(patterns, plens, texts, tlens, quals,
                                       scheme=scheme, atype=atype,
                                       band_w=band_w)
    if kernel == "K4":
        return long_dp.launch(patterns, plens, tlens, quals, texts=texts,
                              with_dirs=True, scheme=scheme, atype=atype,
                              band_w=band_w)
    pats, qual, pl, tl, out = _launch_inputs(patterns, plens, tlens, quals,
                                             band_w)
    tx = _launch.stage_texts(texts, pats.shape[0])
    nb, lp = pats.shape
    dirs = torch.empty((nb, lp, 2 * band_w + 1), dtype=torch.uint8,
                       device=pats.device)
    lib = _build.library()
    rc = lib.k2_banded_directions(
        pats.data_ptr(), qual.data_ptr(), pl.data_ptr(), tx.data_ptr(),
        tl.data_ptr(), nb, lp, tx.shape[1], band_w,
        *_launch.scheme_args(scheme, atype), out.data_ptr(), dirs.data_ptr(),
        _launch.stream(pats.device))
    _build.check(lib, rc, "k2_banded_directions")
    banded_directions.launches += 1
    return _launch.result(out), dirs


#: the wrappers whose launches are counted, by kernel name (all kernels
#: of the port, K5 with its score and its flag entry points)
KERNELS = {
    "K1": banded_score,
    "K2": banded_directions,
    "K3": banded_score_packed,
    "K4": long_dp.launch,
    "K5": wavefront_dp.wavefront_score,
    "K5_dirs": wavefront_dp.wavefront_dirs,
    "K6": myers.myers,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


reset_launch_counts()
