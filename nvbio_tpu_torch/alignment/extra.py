"""Remaining aligner taxonomy: Hamming and full-matrix wrappers.

Port of ``nvbio_tpu/alignment/extra.py`` (ref: nvbio/alignment/
alignment.h ``make_hamming_distance_aligner`` and the full-matrix
``alignment_score`` paths).  The full matrix is the banded engine with
the band covering every diagonal: in the reference the XLA twin
(``banded_score_batch`` at ``band_w = max(Lp, Lt)``), in the port the
same twin contract through K5's score entry point
(``ops.wavefront_dp.wavefront_score``), which launches the kernel on a
CUDA tensor (its matrix mode for a ``MatrixScheme``) and runs the plain
twin on a CPU tensor.  ``hamming_score_batch`` is elementwise torch on
either device, as the reference computes it in ``jnp`` outside any
kernel.
"""

from __future__ import annotations

import torch

from ..ops.wavefront_dp import wavefront_score
from .types import AlignmentType, GotohScheme


def hamming_score_batch(patterns, plens, texts, quals=None, *,
                        scheme: GotohScheme = GotohScheme()):
    """Gapless alignment at offset 0: sum of substitution scores over
    the pattern length (ref: hamming_inl.h semantics).  Returns (R,)
    int32."""
    patterns = patterns.to(torch.int32)
    texts = texts.to(torch.int32)
    R, L = patterns.shape
    if quals is None:
        quals = torch.full((R, L), 40, dtype=torch.int32,
                           device=patterns.device)
    qc = quals.to(torch.int32).clamp(max=40)
    mm = scheme.mismatch_min + (
        (scheme.mismatch_max - scheme.mismatch_min) * qc) // 40
    t = texts[:, :L]
    is_n = (patterns >= 4) | (t >= 4)
    s = torch.where(is_n, -scheme.n_penalty,
                    torch.where(patterns == t, scheme.match, -mm))
    mask = (torch.arange(L, device=patterns.device)[None, :]
            < plens.to(patterns.device)[:, None])
    return torch.where(mask, s, 0).sum(dim=1).to(torch.int32)


def full_score_batch(patterns, plens, texts, tlens, quals=None, *,
                     scheme, atype: AlignmentType):
    """Full-matrix DP: the banded engine with a band spanning all
    diagonals (band_w = max(Lp, Lt)), the twin's raw values.  ``scheme``
    is a ``GotohScheme`` or a ``MatrixScheme``."""
    band_w = max(patterns.shape[1], texts.shape[1])
    return wavefront_score(patterns, plens, texts, tlens, quals,
                           scheme=scheme, atype=atype, band_w=band_w)
