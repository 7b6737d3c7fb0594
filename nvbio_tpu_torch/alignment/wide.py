"""Two-pass wide-band alignment with traceback (score-derived band).

Port of ``nvbio_tpu/alignment/wide.py`` (``derive_tb_band`` ``:59``,
``wide_band_cigar_batch`` ``:104``, ``_wavefront_tb`` ``:255``), for
bands beyond the row-blocked directions kernel's reach (band_w >~ 800):

1. **Score pass** at the requested wide band through
   ``ops/long_dp.banded_score_long``, which sends bands beyond K4's
   reach to the wavefront kernel K5.
2. **Band derivation** (host, exact): a path scoring ``s`` has at most
   ``g = (perfect(Lp) - s - min(open)) // min(extend)`` indels, so the
   optimal path stays within ``g`` diagonals of the end cell's diagonal
   and its leftmost text column is ``>= d_end - g``: a certificate, not
   a heuristic.
3. **Traceback pass** on a window starting at text column
   ``max(d_end - g, 0)`` with the derived band quantised to TB_BANDS:
   ``ops/banded_dp.banded_directions`` (K2, or K4 for Lp > 512) and the
   run-jump walk.

Lanes whose certificate exceeds the ladder take **pass 3**: K5 re-runs on
just those lanes with per-cell flags (``ops/wavefront_dp.wavefront_dirs``,
8 lanes a call) and ``alignment/wavefront_walk`` walks them on the device.

The function runs on the device of its inputs: CUDA tensors launch the
kernels, CPU tensors take their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import banded_dp, long_dp, wavefront_dp
from .types import AlignmentType, GotohScheme, NEG_INF, gap_penalties
from .walk import runjump_walk
from .wavefront_walk import compress_ops, walk_wavefront_dirs_device

#: static band ladder for the traceback pass; 767 is the widest band the
#: JAX directions kernel's VMEM model fits at row_block = 8
TB_BANDS = (31, 63, 127, 255, 511, 767)
PAD_SYMBOL = 7
#: lanes per pass-3 kernel call (bounds the flag bytes)
SLICE = 8


def derive_tb_band(plens, scores, p_end, t_end, scheme, band_w):
    """Per-alignment exact traceback certificate (host NumPy).

    The indel budget ``g`` from the score gap bounds the optimal path's
    diagonal span to ``[d_end - g, d_end + g]`` and its leftmost text
    column to ``>= d_end - g``.  A pass-2 window ``(off, B2)`` covers text
    columns ``[off, ...)`` and diagonals ``[off - B2, off + B2]``, so
    ``off <= d_end - g`` (clipped at 0) and ``B2 >= (d_end + g) - off``.
    With ``min(ee, fe) < 1`` the score does not bound run lengths, and the
    certificate is the original window itself (``off = 0``, ``B2 =
    band_w``).

    Returns ``(need, off)``: the minimal band and the window start."""
    plens = np.asarray(plens, np.int64)
    scores = np.asarray(scores, np.int64)
    d_end = np.asarray(t_end, np.int64) - np.asarray(p_end, np.int64)
    eo, ee, fo, fe = gap_penalties(scheme)
    min_ext = min(ee, fe)
    if min_ext < 1:  # score does not bound indel runs: original band
        n = len(plens)
        return (np.full(n, band_w, np.int64), np.zeros(n, np.int64))
    perfect = plens * scheme.match
    gap = np.maximum(perfect - scores - min(eo, fo), 0)
    g = gap // min_ext
    off = np.maximum(d_end - g, 0)
    need = np.maximum(d_end + g - off, off - (d_end - g))
    cert_wins = need < band_w
    need = np.where(cert_wins, need, band_w)
    off = np.where(cert_wins, off, 0)
    return need.astype(np.int64), off.astype(np.int64)


def _quantize_band(need: int) -> int | None:
    for b in TB_BANDS:
        if need <= b:
            return b
    return None


def pass2_window(texts, tlens, off, lp: int, b2: int):
    """Pass 2's texts and lengths: each lane's text from column ``off[b]``
    (host array), ``lp + 2 * b2`` columns padded with PAD_SYMBOL.  Cell
    (i, k) of the window's banded DP is text column off + i + k - b2."""
    dev = texts.device
    lt2 = lp + 2 * b2
    off_t = torch.from_numpy(off).to(dev)
    texts_p = torch.nn.functional.pad(texts, (0, lt2), value=PAD_SYMBOL)
    texts2 = torch.gather(texts_p, 1, off_t[:, None]
                          + torch.arange(lt2, device=dev)[None, :])
    return texts2, (tlens - off_t).clamp(0, lt2).to(torch.int32)


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def wide_band_cigar_batch(patterns, plens, texts, tlens, quals=None, *,
                          scheme: GotohScheme, atype: AlignmentType,
                          band_w: int, max_tb_band: int = TB_BANDS[-1]):
    """Wide-band banded Gotoh with CIGAR via the two-pass schedule.

    patterns (NB, Lp) symbols (0..3, N >= 4); plens (NB,); texts (NB,
    Lt); tlens (NB,); quals (NB, Lp) or None; tensors on one device.
    Returns a dict of host arrays: ``score``, ``p_end``, ``t_end``
    (coordinates in the ORIGINAL text), ``p_start``, ``t_start``,
    ``run_ops``/``run_lens`` (CIGAR runs in end->start walk order, codes
    {0 none, 1 M, 2 D, 3 I}), ``tb_ok`` (bool: CIGAR present), ``tb_band``
    (the band certificate used)."""
    NB, Lp = patterns.shape
    dev = patterns.device
    # bands past the ladder cannot be walked by the banded pass
    max_tb_band = min(max_tb_band, TB_BANDS[-1])
    plens = plens.to(torch.int32)
    tlens = tlens.to(torch.int32)

    # ---- pass 1: wide-band score (K5 beyond K4's reach) ----
    res1 = long_dp.banded_score_long(patterns, plens, texts, tlens, quals,
                                     scheme=scheme, atype=atype,
                                     band_w=band_w)
    score = _host(res1["score"]).astype(np.int64)
    p_end = _host(res1["p_end"]).astype(np.int64)
    t_end = _host(res1["t_end"]).astype(np.int64)
    plens_h = _host(plens)

    # ---- derive + quantise the traceback band ----
    valid = score > NEG_INF // 2
    need, off = derive_tb_band(plens_h, score, p_end, t_end, scheme, band_w)
    tb_ok = valid & (need <= max_tb_band)
    need_max = int(need[tb_ok].max()) if tb_ok.any() else TB_BANDS[0]
    B2 = _quantize_band(min(need_max, max_tb_band)) or max_tb_band

    out = {
        "score": score, "p_end": p_end, "t_end": t_end,
        "tb_ok": tb_ok, "tb_band": np.full(NB, B2, np.int32),
        "p_start": np.zeros(NB, np.int64),
        "t_start": np.zeros(NB, np.int64),
        "run_ops": np.zeros((NB, 1), np.uint8),
        "run_lens": np.zeros((NB, 1), np.int32),
    }
    # lanes whose certificate exceeds the banded ladder walk the
    # wavefront kernel's own flags instead (pass 3)
    hard = valid & (need > max_tb_band)
    if not tb_ok.any():
        if hard.any():
            _wavefront_tb(out, hard, patterns, plens, texts, tlens, quals,
                          scheme, atype, band_w)
        return out

    # ---- pass 2: re-positioned window, narrow-band directions DP ----
    off = np.where(tb_ok, off, 0)
    texts2, tlens2 = pass2_window(texts, tlens, off, Lp, B2)
    res2, dirs = banded_dp.banded_directions(patterns, plens, texts2,
                                             tlens2, quals, scheme=scheme,
                                             atype=atype, band_w=B2)
    i0 = res2["p_end"].to(torch.int64)
    k0 = res2["t_end"].to(torch.int64) - i0 + B2
    fi, fk, run_ops, run_lens = runjump_walk(
        dirs.reshape(NB, -1), 2 * B2 + 1, i0, k0,
        active=torch.from_numpy(tb_ok).to(dev))

    score2 = _host(res2["score"]).astype(np.int64)
    # the certificate guarantees pass 2 recovers pass 1's optimum; a
    # higher pass-2 score is a better path inside the re-positioned band
    # and is what the CIGAR attains.  A LOWER one would mean the
    # certificate failed: such lanes keep pass 1's score and ends, no
    # CIGAR.
    tb_ok = out["tb_ok"] = tb_ok & (score2 >= score)
    out["score"] = np.where(tb_ok, score2, score)
    p_end2 = _host(res2["p_end"]).astype(np.int64)
    t_end2 = _host(res2["t_end"]).astype(np.int64) + off
    out["p_end"] = np.where(tb_ok, p_end2, p_end)
    out["t_end"] = np.where(tb_ok, t_end2, t_end)
    fi = _host(fi).astype(np.int64)
    fk = _host(fk).astype(np.int64)
    out["p_start"] = np.where(tb_ok, fi, 0)
    out["t_start"] = np.where(tb_ok, off + fi + fk - B2, 0)
    out["run_ops"] = _host(run_ops)
    out["run_lens"] = _host(run_lens)
    if hard.any():
        _wavefront_tb(out, hard, patterns, plens, texts, tlens, quals,
                      scheme, atype, band_w)
    return out


def _wavefront_tb(out, hard, patterns, plens, texts, tlens, quals, scheme,
                  atype, band_w):
    """Pass 3: CIGARs for lanes beyond the certificate ladder.

    Re-runs K5 on just the hard lanes with per-cell flags and walks them
    on the device; only the op streams come to the host.  K5 is the
    recurrence of pass 1, so scores and ends are unchanged; only the
    CIGAR is new.  SLICE lanes a call bound the flag bytes (~8.8 MB a
    lane at Lp 4 000, band_w 2 000)."""
    idx = np.flatnonzero(hard)
    dev = patterns.device
    runs_all = {}
    for s0 in range(0, idx.size, SLICE):
        sl_h = idx[s0:s0 + SLICE]
        sl = torch.from_numpy(sl_h).to(dev)
        res, dirs = wavefront_dp.wavefront_dirs(
            patterns[sl], plens[sl], texts[sl], tlens[sl],
            None if quals is None else quals[sl], scheme=scheme, atype=atype,
            band_w=band_w)
        ops, n, ps, ts = walk_wavefront_dirs_device(
            dirs, res["p_end"], res["t_end"], band_w=band_w,
            lp=patterns.shape[1], lt=texts.shape[1])
        del dirs
        ops_h, n_h, ps_h, ts_h = map(_host, (ops, n, ps, ts))
        sc = _host(res["score"])
        for li, b in enumerate(sl_h):
            # pass 1 and pass 3 run the same kernel: ends must agree
            assert sc[li] == out["score"][b], (b, sc[li], out["score"][b])
            ro, rl = compress_ops(ops_h[li, :n_h[li]])
            runs_all[b] = (ro, rl, int(ps_h[li]), int(ts_h[li]))
    if not runs_all:
        return
    for k in ("run_ops", "run_lens", "p_start", "t_start", "tb_ok",
              "tb_band"):
        out[k] = np.array(out[k])
    width = max(out["run_ops"].shape[1],
                max(len(r[0]) for r in runs_all.values()))
    if width > out["run_ops"].shape[1]:
        pad = width - out["run_ops"].shape[1]
        out["run_ops"] = np.pad(out["run_ops"], ((0, 0), (0, pad)))
        out["run_lens"] = np.pad(out["run_lens"], ((0, 0), (0, pad)))
    for b, (ro, rl, ps, ts) in runs_all.items():
        out["run_ops"][b, :len(ro)] = ro
        out["run_ops"][b, len(ro):] = 0
        out["run_lens"][b, :len(rl)] = rl
        out["run_lens"][b, len(rl):] = 0
        out["p_start"][b] = ps
        out["t_start"][b] = ts
        out["tb_ok"][b] = True
        out["tb_band"][b] = band_w
