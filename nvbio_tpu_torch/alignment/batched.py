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

Either scheme scores the substitution (``_subst_scores``): a
``GotohScheme`` by its quality-aware formula, a ``MatrixScheme`` (protein
SW) by a table gather.

With ``twin=True`` the outputs follow the JAX twin itself
(``nvbio_tpu/alignment/batched.py:139-224``), the contract of the
wavefront kernel K5 (``nvbio_tpu/ops/wavefront_dp.py:33-40``, raw twin
values): no SCORE_FLOOR clamp, and GLOBAL reads the goal cell at
``clip(k, 0, 2w)`` where the Pallas contract says NEG_INF.

The CUDA kernels in ``nvbio_tpu_torch/ops/csrc/banded_gotoh.cu`` (K1-K3)
and ``long_gotoh.cu`` (K4) compute exactly this, several lanes an
alignment (``group_gotoh.cuh``) or one block an alignment.
"""

from __future__ import annotations

import functools

import torch

from .types import AlignmentType, GotohScheme, NEG_INF, gap_penalties

DIAG, FROM_E, FROM_F, ORIGIN = 0, 1, 2, 3
PAD_SYMBOL = 7
#: outputs below this are "no path" (the Pallas kernels' contract)
SCORE_FLOOR = -(1 << 19)


def _is_matrix(scheme) -> bool:
    """A substitution-matrix scheme (``alignment.blosum.MatrixScheme``),
    told apart as the reference's ``_subst_scores`` does."""
    return hasattr(scheme, "matrix")


@functools.lru_cache(maxsize=8)
def _matrix_table(scheme, device: torch.device) -> torch.Tensor:
    """A matrix scheme's (K, K) int32 table on ``device``, made once."""
    return torch.from_numpy(scheme.matrix_np).to(device)


def _subst_scores(p, q, tsl, scheme: GotohScheme):
    """Substitution scores: p, q (B,) int32; tsl (B, BAND) int32.

    A ``GotohScheme`` scores by the quality-aware match/mismatch formula,
    a ``MatrixScheme`` (``alignment/blosum.py``, protein SW) by the
    reference's matrix gather (``nvbio_tpu/alignment/batched.py:41-46``):
    p and t clipped to [0, K - 1], ``matrix[p, t]``, quality ignored."""
    if _is_matrix(scheme):
        mat = _matrix_table(scheme, tsl.device)
        K = mat.shape[0]
        return mat[p.clamp(0, K - 1)[:, None],
                   tsl.clamp(0, K - 1)].to(torch.int32)
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


#: the int16 DP's masked-cell value (``_make_kernel_masked``'s NEG_VAL)
NEG16 = -20000


def band_pad(band: int) -> int:
    """The band's extent in the JAX kernels (``banded_dp.py:51``)."""
    return max(8, (band + 7) // 8 * 8)


def band16_rows(plens, tlens, lp: int, band_w: int):
    """The rows K7's plain version runs and the band cells valid in
    each: ``(i0, valid)`` with ``valid`` (NB, band_pad(2w + 1)) true
    where cell k of row i0 + 1 holds text column ``j = i0 + 1 + k - w``
    in ``[0, tlen]``.  Rows stop at Lp8 and at the longest pattern
    (the rows past every pattern's end record nothing)."""
    band = 2 * band_w + 1
    lp8 = (lp + 7) // 8 * 8
    tlen = tlens.to(torch.int32).to(torch.int16)[:, None]
    krange = torch.arange(band_pad(band), dtype=torch.int16,
                          device=tlens.device)[None, :]
    in_band = krange < band
    plen = plens.to(torch.int32).to(torch.int16)
    n_rows = min(lp8, int(plen.max()) if len(plen) else 0)
    for i0 in range(n_rows):
        j = krange + (i0 + 1 - band_w)
        yield i0, (j >= 0) & (j <= tlen) & in_band


def banded_score_batch16(patterns, plens, texts, tlens, quals=None, *,
                         scheme: GotohScheme, atype: AlignmentType,
                         band_w: int):
    """K7's plain version: the int16 masked banded Gotoh of
    ``nvbio_tpu/ops/banded_dp.py`` ``_make_kernel_masked`` (``:117``),
    transcribed op for op in ``torch.int16`` (so any wrap is the one JAX
    makes), over the same staging (``:798-820``): patterns padded to
    Lp8 rows of PAD with quality 0, text row ``i0 + k`` holding window
    symbol ``i0 + k - w``, PAD outside ``[0, min(Lt, tlen))``; the band
    padded to ``band_pad(2w + 1)`` cells, the extra cells masked; E by a
    Kogge-Stone weighted cumulative max whose shifts fill NEG16.

    Its own output contract (not K1's): the int32 reductions of
    ``:241-286``.  Non-LOCAL snapshots at or below NEG16 // 2 are no
    path (NEG_INF); GLOBAL reads the goal cell k = tlen - plen + w
    (NEG_INF outside the band); SEMI_GLOBAL takes the smallest k among
    the best cells, so a lane with no path gets t_end = max(plen - w,
    0); LOCAL the earliest row, then the smallest k.  Zero-length
    patterns give score 0 (LOCAL) or NEG_INF, p_end 0 and k = w.
    Exact only inside the reference's guard (``ops.banded_dp.int16_ok``)."""
    i16, i32 = torch.int16, torch.int32
    eo, ee, fo, fe = gap_penalties(scheme)
    local = atype == AlignmentType.LOCAL
    nb, lp = patterns.shape
    dev = patterns.device
    BAND = 2 * band_w + 1
    BP = band_pad(BAND)
    lp8 = (lp + 7) // 8 * 8
    lt_pad = lp8 + BP + 16
    pats = torch.nn.functional.pad(patterns.to(i32), (0, lp8 - lp),
                                   value=PAD_SYMBOL)
    quals = (torch.full((nb, lp), 40, dtype=i32, device=dev)
             if quals is None else quals.to(i32))
    quals = torch.nn.functional.pad(quals, (0, lp8 - lp), value=0)
    tx = torch.nn.functional.pad(
        texts.to(i32), (band_w, max(0, lt_pad - band_w - texts.shape[1])),
        value=PAD_SYMBOL)[:, :lt_pad]
    plens32, tlens32 = plens.to(i32), tlens.to(i32)
    m = torch.arange(lt_pad, dtype=i32, device=dev) - band_w
    tx = torch.where(m[None, :] >= tlens32[:, None], PAD_SYMBOL, tx)

    def shift_up_by(x, d):
        """out[k] = x[k - d], NEG16 at k < d."""
        return torch.nn.functional.pad(x[:, :-d], (d, 0), value=NEG16)

    plen = plens32.to(i16)[:, None]
    tlen = tlens32.to(i16)[:, None]
    krange = torch.arange(BP, dtype=i16, device=dev)[None, :]
    in_band = krange < BAND
    kk = krange * ee
    j0 = krange - band_w
    if atype == AlignmentType.GLOBAL:
        h0 = torch.where(j0 == 0, 0, torch.where(j0 > 0, -(eo + ee * j0),
                                                 NEG16)).to(i16)
    else:
        h0 = torch.where(j0 >= 0, 0, NEG16).to(i16)
    H = torch.where((j0 <= tlen) & in_band, h0, NEG16).to(i16)
    F = torch.full((nb, BP), NEG16, dtype=i16, device=dev)
    snapH = torch.full((nb, BP), 0 if local else NEG16, dtype=i16,
                       device=dev)
    snapR = torch.zeros((nb, BP), dtype=i16, device=dev)
    for i0, valid in band16_rows(plens32, tlens32, lp, band_w):
        q = quals[:, i0:i0 + 1]
        mm = (scheme.mismatch_min + ((scheme.mismatch_max
                                      - scheme.mismatch_min)
                                     * q.clamp(max=40)) // 40).to(i16)
        t16 = tx[:, i0:i0 + BP].to(i16)
        p16 = pats[:, i0:i0 + 1].to(i16)
        is_n = (p16 >= 4) | (t16 >= 4)
        s = torch.where(is_n, -scheme.n_penalty,
                        torch.where(t16 == p16, scheme.match, -mm)).to(i16)
        up_H = torch.nn.functional.pad(H[:, 1:], (0, 1), value=NEG16)
        up_F = torch.nn.functional.pad(F[:, 1:], (0, 1), value=NEG16)
        F_new = torch.maximum(up_H - (fo + fe), up_F - fe)
        Hhat = torch.maximum(H + s, F_new)
        if local:
            Hhat = Hhat.clamp(min=0)
        Hhat_m = torch.where(valid, Hhat, NEG16)
        Ew = (shift_up_by(Hhat_m, 1) - (eo + ee)) + kk
        d = 1
        while d < BP:
            Ew = torch.maximum(Ew, shift_up_by(Ew, d))
            d *= 2
        H_new = torch.maximum(Hhat, Ew - kk)
        if local:
            H_new = H_new.clamp(min=0)
        H = torch.where(valid, H_new, NEG16)
        F = torch.where(valid, F_new, NEG16)
        row = i0 + 1
        if local:  # per-cell running max; the earliest row wins ties
            upd = (H > snapH) & (row <= plen)
            snapH = torch.where(upd, H, snapH)
            snapR = torch.where(upd, row, snapR)
        else:  # the snapshot of each lane's last pattern row
            snapH = torch.where(row == plen, H, snapH)

    snap = snapH.to(i32)
    if not local:
        snap = torch.where(snap <= NEG16 // 2, NEG_INF, snap)
    kr = torch.arange(BP, dtype=i32, device=dev)[None, :]
    if atype == AlignmentType.GLOBAL:
        k_goal = tlens32 - plens32 + band_w
        best = torch.where(kr == k_goal[:, None], snap, NEG_INF).max(1).values
        best_i, best_k = plens32, k_goal
    elif atype == AlignmentType.SEMI_GLOBAL:
        best = snap.max(1).values
        best_k = torch.where(snap == best[:, None], kr, BP).min(1).values
        best_i = plens32
    else:
        best = snap.max(1).values
        key = snapR.to(i32) * BP + kr
        best_key = torch.where(snap == best[:, None], key,
                               1 << 30).min(1).values
        best_i, best_k = best_key // BP, best_key % BP
    zero_len = plens32 <= 0
    best = torch.where(zero_len, 0 if local else NEG_INF, best)
    best_i = torch.where(zero_len, 0, best_i)
    best_k = torch.where(zero_len, band_w, best_k)
    return {"score": best.to(i32), "p_end": best_i.to(i32),
            "t_end": (best_i + best_k - band_w).clamp(min=0).to(i32)}
