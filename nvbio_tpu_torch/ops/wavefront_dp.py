"""K5: wide-band banded Gotoh along anti-diagonals, score-only and with
flags.

Port of ``nvbio_tpu/ops/wavefront_dp.py`` (``wavefront_score_pallas``
``:349``, ``wavefront_dirs_pallas`` ``:321``, both through
``_wavefront_call`` ``:372``).  The kernel is ``csrc/wavefront_gotoh.cu``
(built by ``_build.py`` at first use): one block per alignment, the
anti-diagonal across its threads, every diagonal in a loop inside the
block.

K5 returns raw twin values (``wavefront_dp.py:33-40``): its plain version
is ``alignment/batched.py`` ``banded_score_batch(twin=True)``, and the
plain version of its flags is the twin's flags
(``banded_directions_batch``) laid out as the kernel writes them
(``twin_flags_to_diagonals``).  The wrappers take the plain versions for
tensors on the CPU, and only then; for CUDA tensors they launch the kernel
or raise.  ``wavefront_score.launches`` and ``wavefront_dirs.launches``
count the launches.

Flag layout (the port's own; only ``alignment/wavefront_walk.py`` reads
it).  Cell (r, j) lies on diagonal d = r + j at slot q = r - rlo(d), with
rlo(d) = ceil((d - w) / 2), so the in-band cells of a diagonal (|j - r|
<= w) are slots 0..w.  dirs is (NB, D, ceil((w + 1) / 2)) uint8 with
D = Lp + Lt + 1: two slots per byte, slot q in the low nibble when q is
even.  The nibble is the twin's encoding (bits 0-1 H source diag / E / F
/ origin, bit 2 E open, bit 3 F open); row 0, cells outside the band and
invalid cells (j < 0 or j > tlen) hold 3.
"""

from __future__ import annotations

import torch

from ..alignment.batched import banded_directions_batch, banded_score_batch
from ..alignment.types import AlignmentType, GotohScheme, gap_penalties
from . import _build, _launch

#: flag bytes one call may allocate (``wavefront_dp.py:436``)
MAX_DIRS_BYTES = 6 << 30


def kmul(band_w: int) -> int:
    """The sink key multiplier of the JAX kernel (``wavefront_dp.py:310``):
    key = r * KMUL + k."""
    return 1 << max(2 * band_w + 2, 2).bit_length()


def check_wavefront(lp: int, lt: int, band_w: int, scheme) -> None:
    """The JAX kernel's two asserts, as ValueError: the sink key range
    (``wavefront_dp.py:311-313``) and the score range (``:384-385``)."""
    if band_w < 0 or lp < 1:
        raise ValueError(f"band_w={band_w}, Lp={lp}: need band_w >= 0 and "
                         "Lp >= 1")
    km = kmul(band_w)
    if (lp + 2) * km >= 1 << 31:
        raise ValueError(
            f"pattern too long for the sink key encoding at band_w={band_w}"
            f" (Lp={lp}, KMUL={km})")
    maxpen = max(scheme.mismatch_max, scheme.n_penalty, abs(scheme.match),
                 *gap_penalties(scheme))
    if (lp + lt + 2 * band_w + 4) * maxpen >= 1 << 29:
        raise ValueError("score range too wide for the int32 body")


def flag_shape(lp: int, lt: int, band_w: int) -> tuple[int, int]:
    """(D, bytes per diagonal) of the flag layout (module docstring)."""
    return lp + lt + 1, (band_w + 2) // 2


def twin_flags_to_diagonals(dirs, lt: int, band_w: int) -> torch.Tensor:
    """The twin's flags (NB, Lp, 2w+1), row r at index r - 1 and band
    column k = j - r + w, in the kernel's diagonal layout (NB, D, DB);
    3 outside the twin's rows and band.  Cells of the twin's rows that
    are invalid already hold 3 there."""
    nb, lp, band = dirs.shape
    ndiag, db = flag_shape(lp, lt, band_w)
    dev = dirs.device
    d = torch.arange(ndiag, device=dev)[:, None]
    q = torch.arange(2 * db, device=dev)[None, :]
    r = -torch.div(band_w - d, 2, rounding_mode="floor") + q
    k = d - 2 * r + band_w
    ok = (r >= 1) & (r <= lp) & (k >= 0) & (k < band) & (q <= band_w)
    flat = ((r - 1).clamp(0, lp - 1) * band + k.clamp(0, band - 1))
    nib = torch.where(ok[None], dirs.reshape(nb, -1)[:, flat.reshape(-1)]
                      .reshape(nb, ndiag, 2 * db).to(torch.int32), 3)
    return (nib[:, :, 0::2] | (nib[:, :, 1::2] << 4)).to(torch.uint8)


def wavefront_dirs_plain(patterns, plens, texts, tlens, quals=None, *,
                         scheme: GotohScheme, atype: AlignmentType,
                         band_w: int):
    """K5-with-flags' plain version: the twin's score and flags, the flags
    in the kernel's layout."""
    res, dirs = banded_directions_batch(patterns, plens, texts, tlens, quals,
                                        scheme=scheme, atype=atype,
                                        band_w=band_w, twin=True)
    return res, twin_flags_to_diagonals(dirs, texts.shape[1], band_w)


def _launch_k5(patterns, plens, texts, tlens, quals, scheme, atype, band_w,
               with_dirs):
    pats, qual, pl, tl, out = _launch.stage_inputs(patterns, plens, tlens,
                                                   quals)
    tx = _launch.stage_texts(texts, pats.shape[0])
    nb, lp = pats.shape
    lt = tx.shape[1]
    dev = pats.device
    lib = _build.library()
    # a block's DP state lives in shared memory up to the capacity the
    # library reports, beyond it in this scratch (one slice per block)
    words = lib.k5_state_words(band_w)
    scratch = torch.empty((nb if words else 1, max(words, 1)),
                          dtype=torch.int32, device=dev)
    args = (pats.data_ptr(), qual.data_ptr(), pl.data_ptr(), tx.data_ptr(),
            tl.data_ptr(), nb, lp, lt, band_w,
            *_launch.scheme_args(scheme, atype), scratch.data_ptr(),
            out.data_ptr())
    if with_dirs:
        ndiag, db = flag_shape(lp, lt, band_w)
        if nb * ndiag * db > MAX_DIRS_BYTES:
            raise ValueError(
                f"wavefront flags would need {nb * ndiag * db / 2**30:.1f} "
                "GiB; walk fewer alignments per call")
        dirs = torch.empty((nb, ndiag, db), dtype=torch.uint8, device=dev)
        rc = lib.k5_wavefront_directions(*args, dirs.data_ptr(),
                                         _launch.stream(dev))
        _build.check(lib, rc, "k5_wavefront_directions")
        return _launch.result(out), dirs
    rc = lib.k5_wavefront_score(*args, _launch.stream(dev))
    _build.check(lib, rc, "k5_wavefront_score")
    return _launch.result(out)


def wavefront_score(patterns, plens, texts, tlens, quals=None, *,
                    scheme: GotohScheme, atype: AlignmentType, band_w: int):
    """K5 score-only: wide-band banded Gotoh score + sink, raw twin values.

    patterns (NB, Lp) symbols (0..3, N >= 4); texts (NB, Lt); plens,
    tlens (NB,); quals (NB, Lp) or None (= 40).  Returns dict of (NB,)
    int32 ``score``, ``p_end``, ``t_end``."""
    check_wavefront(patterns.shape[1], texts.shape[1], band_w, scheme)
    if _launch.on_cpu(patterns, plens, texts, tlens, quals):
        return banded_score_batch(patterns, plens, texts, tlens, quals,
                                  scheme=scheme, atype=atype, band_w=band_w,
                                  twin=True)
    res = _launch_k5(patterns, plens, texts, tlens, quals, scheme, atype,
                     band_w, with_dirs=False)
    wavefront_score.launches += 1
    return res


def wavefront_dirs(patterns, plens, texts, tlens, quals=None, *,
                   scheme: GotohScheme, atype: AlignmentType, band_w: int):
    """K5 with flags: ``wavefront_score``'s outputs plus one 4-bit flag
    per band cell in the diagonal layout (module docstring).

    Returns (result dict, dirs (NB, Lp + Lt + 1, ceil((w + 1) / 2))
    uint8)."""
    check_wavefront(patterns.shape[1], texts.shape[1], band_w, scheme)
    if _launch.on_cpu(patterns, plens, texts, tlens, quals):
        return wavefront_dirs_plain(patterns, plens, texts, tlens, quals,
                                    scheme=scheme, atype=atype,
                                    band_w=band_w)
    res = _launch_k5(patterns, plens, texts, tlens, quals, scheme, atype,
                     band_w, with_dirs=True)
    wavefront_dirs.launches += 1
    return res


wavefront_score.launches = 0
wavefront_dirs.launches = 0
