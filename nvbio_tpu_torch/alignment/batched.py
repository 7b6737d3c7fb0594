"""Batched banded Gotoh DP in plain PyTorch: the kernels' reference
versions.

Port of ``nvbio_tpu/alignment/batched.py`` (``banded_score_batch``
``:139``, ``banded_directions_batch`` ``:230``): one Python loop step
per pattern row, vectorised over the batch and the band.  Band
coordinates: cell (i, j) lives at k = j - i + w, so the diagonal
dependency is at the same k, the vertical one at k + 1 of the previous
row and the horizontal one at k - 1 of the same row.  The within-row
horizontal-gap recurrence ``E[k] = max(E[k-1] - ee, Hhat[k-1] - eo -
ee)`` is solved exactly as a weighted cumulative max.

The DP itself mirrors the JAX twin cell for cell (invalid cells, j < 0
or j > tlen, are masked to NEG_INF every row, and flags are computed
from the masked values), so direction flags equal the twin's on every
cell.  The outputs follow the Pallas kernels' contract
(``nvbio_tpu/ops/banded_dp.py:436-478``):

- SEMI_GLOBAL: best over the last row's valid cells, lowest k on ties;
- LOCAL: best over rows <= plen, earliest row then lowest k on ties;
  the sink is defined only when the score is > 0;
- GLOBAL: the cell k = tlen - plen + w of row plen, NEG_INF when that
  cell lies outside the band;
- scores below SCORE_FLOOR are reported as NEG_INF;
- zero-length patterns score NEG_INF (0 in LOCAL) with p_end = 0;
- t_end = max(p_end + k - w, 0).

With ``twin=True`` the outputs follow the JAX twin itself
(``nvbio_tpu/alignment/batched.py:139-224``), the contract of the
wavefront kernel K5 (``nvbio_tpu/ops/wavefront_dp.py:33-40``, raw twin
values): no SCORE_FLOOR clamp, and GLOBAL reads the goal cell at
``clip(k, 0, 2w)`` where the Pallas contract says NEG_INF.

The CUDA kernels in ``nvbio_tpu_torch/ops/csrc/banded_gotoh.cu``
compute exactly this, one thread per alignment.
"""

from __future__ import annotations

import torch

from .types import AlignmentType, GotohScheme, NEG_INF, gap_penalties

DIAG, FROM_E, FROM_F, ORIGIN = 0, 1, 2, 3
PAD_SYMBOL = 7
#: outputs below this are "no path" (the Pallas kernels' contract)
SCORE_FLOOR = -(1 << 19)


def _subst_scores(p, q, tsl, scheme: GotohScheme):
    """Substitution scores: p, q (B,) int32; tsl (B, BAND) int32."""
    mm = scheme.mismatch_min + (
        (scheme.mismatch_max - scheme.mismatch_min) * q.clamp(max=40)) // 40
    p_ = p[:, None]
    is_n = (p_ >= 4) | (tsl >= 4)
    return torch.where(
        is_n, -scheme.n_penalty,
        torch.where(p_ == tsl, scheme.match, -mm[:, None])).to(torch.int32)


def _shift_up_k(x):
    """out[k] = x[k-1], NEG_INF at k = 0."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=NEG_INF)


def _shift_down_k(x):
    """out[k] = x[k+1], NEG_INF at the last k."""
    return torch.nn.functional.pad(x[:, 1:], (0, 1), value=NEG_INF)


def _prepare(patterns, plens, texts, tlens, quals, band_w):
    patterns = patterns.to(torch.int32)
    nb, Lp = patterns.shape
    quals = (torch.full((nb, Lp), 40, dtype=torch.int32,
                        device=patterns.device)
             if quals is None else quals.to(torch.int32))
    # tp[:, i0 + k] = text[i0 + k - w]; PAD beyond both ends
    need = Lp + 2 * band_w + 1
    pad_right = max(0, need - band_w - texts.shape[1])
    tp = torch.nn.functional.pad(texts.to(torch.int32),
                                 (band_w, pad_right), value=PAD_SYMBOL)
    return (patterns, plens.to(torch.int32), tp, tlens.to(torch.int32),
            quals)


def _row0(tlens, band_w, atype, scheme, nb):
    BAND = 2 * band_w + 1
    j0 = torch.arange(BAND, dtype=torch.int32, device=tlens.device) - band_w
    if atype == AlignmentType.GLOBAL:
        h0 = torch.where(j0 == 0, 0, torch.where(
            j0 > 0, -(scheme.gap_open + scheme.gap_extend * j0), NEG_INF))
    else:
        h0 = torch.where(j0 >= 0, 0, NEG_INF)
    h0 = h0.to(torch.int32)[None, :].expand(nb, BAND)
    return torch.where(j0[None, :] <= tlens[:, None], h0,
                       NEG_INF).to(torch.int32)


def _banded_dp(patterns, plens, texts, tlens, quals, scheme, atype, band_w,
               want_dirs: bool, twin: bool = False):
    """Shared row loop.  Returns (result dict, dirs (B, Lp, BAND) uint8
    or None); ``twin`` selects the JAX twin's output contract."""
    eo, ee, fo, fe = gap_penalties(scheme)
    local = atype == AlignmentType.LOCAL
    pats, plens, tp, tlens, quals = _prepare(patterns, plens, texts, tlens,
                                             quals, band_w)
    nb, Lp = pats.shape
    dev = pats.device
    BAND = 2 * band_w + 1
    karange = torch.arange(BAND, dtype=torch.int32, device=dev)
    kk = (karange * ee)[None, :]
    H = _row0(tlens, band_w, atype, scheme, nb)
    F = torch.full((nb, BAND), NEG_INF, dtype=torch.int32, device=dev)
    best = torch.full((nb,), 0 if local else NEG_INF, dtype=torch.int32,
                      device=dev)
    best_i = torch.zeros(nb, dtype=torch.int32, device=dev)
    best_k = torch.full((nb,), band_w, dtype=torch.int32, device=dev)
    k_goal = tlens - plens + band_w
    dirs = (torch.empty((nb, Lp, BAND), dtype=torch.uint8, device=dev)
            if want_dirs else None)
    # rows past every pattern's end change no score: the score-only
    # loop stops at the longest pattern, the flag loop fills all rows
    n_rows = Lp if want_dirs else min(Lp, int(plens.max()) if nb else 0)
    for i0 in range(n_rows):
        tsl = tp[:, i0 : i0 + BAND]
        j = (i0 + 1) + karange[None, :] - band_w
        valid = (j >= 0) & (j <= tlens[:, None])
        s = _subst_scores(pats[:, i0], quals[:, i0], tsl, scheme)
        up_H = _shift_down_k(H)
        up_F = _shift_down_k(F)
        f_open = up_H - (fo + fe)
        F_new = torch.maximum(f_open, up_F - fe)
        Hdiag = H + s
        Hhat = torch.maximum(Hdiag, F_new)
        if local:
            Hhat = Hhat.clamp(min=0)
        A = _shift_up_k(torch.where(valid, Hhat, NEG_INF)) - (eo + ee)
        E_new = torch.cummax(A + kk, dim=1).values - kk
        H_new = torch.maximum(Hhat, E_new)
        if local:
            H_new = H_new.clamp(min=0)
        H_new = torch.where(valid, H_new, NEG_INF)
        F_new = torch.where(valid, F_new, NEG_INF)
        if want_dirs:
            E_m = torch.where(valid, E_new, NEG_INF)
            flag = torch.where(H_new == Hdiag, DIAG,
                               torch.where(H_new == E_m, FROM_E, FROM_F))
            if local:
                flag = torch.where(H_new <= 0, ORIGIN, flag)
            flag = torch.where(valid, flag, ORIGIN)
            dirs[:, i0, :] = (flag | ((E_m == A).to(torch.int32) << 2)
                              | ((F_new == f_open).to(torch.int32) << 3)
                              ).to(torch.uint8)
        H, F = H_new, F_new

        row = i0 + 1
        if atype == AlignmentType.GLOBAL:
            hit = plens == row
            in_band = (k_goal >= 0) & (k_goal < BAND)
            h_goal = torch.gather(H_new, 1, k_goal.clamp(0, BAND - 1)
                                  .to(torch.int64)[:, None])[:, 0]
            if not twin:
                h_goal = torch.where(in_band, h_goal, NEG_INF)
            best = torch.where(hit, h_goal, best)
            best_i = torch.where(hit, row, best_i)
            best_k = torch.where(hit, k_goal, best_k)
            continue
        row_best = H_new.max(dim=1).values
        # first maximum (lowest k) on ties
        row_k = torch.where(H_new == row_best[:, None], karange[None, :],
                            BAND).min(dim=1).values
        if atype == AlignmentType.SEMI_GLOBAL:
            upd = plens == row
        else:  # LOCAL: earliest row wins on ties
            upd = (row <= plens) & (row_best > best)
        best = torch.where(upd, row_best, best)
        best_i = torch.where(upd, row, best_i)
        best_k = torch.where(upd, row_k, best_k)

    if not twin:
        best = torch.where(best < SCORE_FLOOR, NEG_INF, best)
    zero_len = plens <= 0
    best = torch.where(zero_len, 0 if local else NEG_INF, best)
    best_i = torch.where(zero_len, 0, best_i)
    best_k = torch.where(zero_len, band_w, best_k)
    res = {
        "score": best.to(torch.int32),
        "p_end": best_i.to(torch.int32),
        "t_end": (best_i + best_k - band_w).clamp(min=0).to(torch.int32),
    }
    return res, dirs


def banded_score_batch(patterns, plens, texts, tlens, quals=None, *,
                       scheme: GotohScheme, atype: AlignmentType,
                       band_w: int, twin: bool = False):
    """Score-only banded alignment of each (pattern, text) pair.

    patterns (B, Lp) symbols (0..3, N >= 4); texts (B, Lt); plens,
    tlens (B,); quals (B, Lp) or None (= 40).  Returns dict of (B,)
    int32 ``score``, ``p_end``, ``t_end``: the Pallas kernels' contract,
    or with ``twin`` the JAX twin's raw values (module docstring)."""
    return _banded_dp(patterns, plens, texts, tlens, quals, scheme, atype,
                      band_w, want_dirs=False, twin=twin)[0]


def banded_directions_batch(patterns, plens, texts, tlens, quals=None, *,
                            scheme: GotohScheme, atype: AlignmentType,
                            band_w: int, twin: bool = False):
    """``banded_score_batch`` plus per-cell traceback flags (uint8; bits
    0-1: H source diag/E/F/origin, bit 2: E open, bit 3: F open).

    Returns (result dict, dirs (B, Lp, BAND) uint8)."""
    return _banded_dp(patterns, plens, texts, tlens, quals, scheme, atype,
                      band_w, want_dirs=True, twin=twin)
