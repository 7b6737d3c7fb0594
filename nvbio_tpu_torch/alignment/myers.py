"""Myers bit-vector edit distance in plain PyTorch: K6's plain version.

Port of ``nvbio_tpu/alignment/myers.py`` (``_myers`` ``:61``,
``myers_edit_distance_batch`` ``:150``, ``edit_distance_oracle``
``:170``): one Python loop step per text column, vectorised over the
batch, on (N, W) bit-vector words with W = ceil(Lp / 32).  The words are
held as int64 values in [0, 2^32) (torch has no full uint32 arithmetic);
the add with carry across words is a carry-lookahead over the word axis,
as the TPU kernel does it (``nvbio_tpu/ops/myers_pallas.py:108-121``).

Modes: GLOBAL, the edit distance of the pattern against the whole text;
SEMI_GLOBAL, the least edit distance against any text substring and its
(1-based) end column.  Symbols >= 4 never match.  The CUDA kernel
``ops/csrc/myers.cu`` computes exactly this.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import AlignmentType

_M32 = 0xFFFFFFFF


def _shift_words(x, fill: int = 0):
    """word w <- word w - 1 along the last axis; ``fill`` into word 0."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=fill)


def _add_with_carry(a, b):
    """(a + b) mod 2^(32 W) over (N, W) words, little-endian word order."""
    s0 = a + b
    g = s0 >> 32  # carry out of each word on its own
    s0 = s0 & _M32
    p = (s0 == _M32).to(torch.int64)  # a carry in would pass through
    step = 1
    while step < a.shape[1]:
        g = g | (p & torch.nn.functional.pad(g[:, :-step], (step, 0)))
        p = p & torch.nn.functional.pad(p[:, :-step], (step, 0))
        step *= 2
    return (s0 + _shift_words(g)) & _M32


def _shift_left1(x, fill: int):
    """(x << 1) across words, ``fill`` into bit 0 of word 0."""
    return ((x << 1) & _M32) | _shift_words(x >> 31, fill)


def _low_bits_mask(m, W: int):
    """(N, W) words with the low m bits set (m >= 1)."""
    bit = torch.arange(W * 32, device=m.device)
    bits = (bit[None, :] < m[:, None]).to(torch.int64).reshape(-1, W, 32)
    return (bits << torch.arange(32, device=m.device)).sum(dim=2)


def myers_edit_distance_batch(patterns, plens, texts, tlens, *,
                              atype: AlignmentType = AlignmentType.SEMI_GLOBAL):
    """Batched bit-vector edit distance.

    patterns (N, Lp) symbols (>= 4 never match); plens (N,); texts (N,
    Lt); tlens (N,).  Returns (distance, t_end) int32 (N,): for
    SEMI_GLOBAL the least distance over text end columns and its
    (1-based) end; for GLOBAL the distance against the whole text and
    tlens."""
    if atype == AlignmentType.LOCAL:
        raise ValueError("Myers aligner is GLOBAL/SEMI_GLOBAL only")
    pats = patterns.to(torch.int64)
    texts = texts.to(torch.int64)
    plens = plens.to(torch.int64)
    tlens = tlens.to(torch.int64)
    N, Lp = pats.shape
    Lt = texts.shape[1]
    W = (Lp + 31) // 32
    dev = pats.device
    bitpos = torch.arange(W * 32, device=dev)
    in_len = bitpos[None, :Lp] < plens[:, None]
    weights = torch.arange(32, device=dev)

    def words(hit):
        hit = torch.nn.functional.pad(hit.to(torch.int64), (0, W * 32 - Lp))
        return (hit.reshape(N, W, 32) << weights).sum(dim=2)

    peq = torch.stack([words((pats == c) & in_len) for c in range(4)], dim=1)
    peq = torch.cat([peq, torch.zeros_like(peq[:, :1])], dim=1)  # no match
    lens_mask = _low_bits_mask(plens.clamp(min=1), W)
    m1 = (plens - 1).clamp(min=0)
    end_word = (m1 // 32)[:, None]
    end_bit = m1 % 32
    fill = 1 if atype == AlignmentType.GLOBAL else 0
    rows = torch.arange(N, device=dev)

    vp = lens_mask
    vn = torch.zeros_like(vp)
    dist = plens.clone()
    best = torch.where(plens > 0, 1 << 30, 0)
    bestj = torch.zeros_like(plens)
    for j in range(Lt):
        c = texts[:, j]
        eq = peq[rows, torch.where((c >= 0) & (c < 4), c, 4)]
        xv = eq | vn
        xh = (_add_with_carry(eq & vp, vp) ^ vp) | eq
        ph = vn | (~(xh | vp) & _M32)
        mh = vp & xh
        ebit = (torch.gather(ph, 1, end_word)[:, 0] >> end_bit) & 1
        mbit = (torch.gather(mh, 1, end_word)[:, 0] >> end_bit) & 1
        ndist = dist + ebit - mbit
        ph = _shift_left1(ph, fill) & lens_mask
        mh = _shift_left1(mh, 0) & lens_mask
        nvp = (mh | (~(xv | ph) & _M32)) & lens_mask
        nvn = (ph & xv) & lens_mask
        active = j < tlens
        vp = torch.where(active[:, None], nvp, vp)
        vn = torch.where(active[:, None], nvn, vn)
        dist = torch.where(active, ndist, dist)
        upd = active & (dist < best)
        best = torch.where(upd, dist, best)
        bestj = torch.where(upd, j + 1, bestj)
    if atype == AlignmentType.GLOBAL:
        return dist.to(torch.int32), tlens.to(torch.int32)
    best = torch.minimum(best, plens)  # the empty-text alignment
    return best.to(torch.int32), bestj.to(torch.int32)


def edit_distance_oracle(pat, text, atype=AlignmentType.SEMI_GLOBAL):
    """Scalar Levenshtein DP oracle (NumPy) for tests."""
    pat = np.asarray(pat)
    text = np.asarray(text)
    m, n = len(pat), len(text)
    D = np.zeros((m + 1, n + 1), np.int32)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(n + 1) if atype == AlignmentType.GLOBAL else 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = 0 if (pat[i - 1] == text[j - 1] and pat[i - 1] < 4) else 1
            D[i, j] = min(D[i - 1, j - 1] + sub, D[i - 1, j] + 1,
                          D[i, j - 1] + 1)
    if atype == AlignmentType.GLOBAL:
        return int(D[m, n])
    return int(D[m, :].min())
