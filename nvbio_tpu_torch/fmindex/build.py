"""FM-index construction on the host (numpy + the native C++ library).

Port of ``nvbio_tpu/fmindex/build.py`` (``build_fm_arrays`` ``:106``,
``build_kmer_lut`` ``:220``), which imports JAX: the same arrays, from
the same native passes (the port's copy ``nvbio_tpu_torch.native``: SA-IS, the fused BWT +
occ pass, the SSA pass, the k-mer histogram), with the same numpy
fallbacks when the native library cannot be built.
"""

from __future__ import annotations

import numpy as np

from ..basic.packed import pack_2bit
from ..native import (fm_bwt_occ_native, kmer_hist_native, sais_native,
                      ssa_build_native)

BLOCK = 128  # symbols per occ block (the native pass hardcodes it)
WORDS = BLOCK // 16


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array (sentinel-smallest) by native SA-IS, or numpy
    prefix doubling when the native library is unavailable."""
    t = np.ascontiguousarray(text, dtype=np.uint8)
    sa = sais_native(t)
    return sa if sa is not None else suffix_array_pd(t)


def suffix_array_pd(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling (Manber-Myers) suffix array, vectorised numpy
    (``nvbio_tpu/sufsort/sa.py:suffix_array_pd``)."""
    t = np.asarray(text, dtype=np.int64)
    n = len(t)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = t.copy()
    k = 1
    tmp = np.empty(n, dtype=np.int64)
    while True:
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        key = rank * (n + 1) + (second + 1)
        sa = np.argsort(key, kind="stable")
        sorted_key = key[sa]
        tmp[0] = 0
        np.cumsum(sorted_key[1:] != sorted_key[:-1], out=tmp[1:])
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[sa] = tmp
        rank = new_rank
        if tmp[n - 1] == n - 1 or 2 * k >= n:
            return sa
        k *= 2


def bwt_from_sa(text: np.ndarray, sa: np.ndarray):
    """(bwt of text + sentinel, primary); the sentinel slot holds 'A'."""
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    primary = int(np.flatnonzero(sa == 0)[0]) + 1
    bwt = np.empty(n + 1, dtype=np.uint8)
    bwt[0] = text[n - 1]  # row 0 is the '$' suffix
    bwt[1:] = text[(np.asarray(sa, np.int64) - 1) % n]
    bwt[primary] = 0
    return bwt, primary


def _occ_tables_host(bwt_pad: np.ndarray, n_blocks: int):
    """Blocked occ tables: counts before each block (int32) and within
    the block before each 16-symbol word (int8, <= 112)."""
    n_words16 = n_blocks * WORDS
    w16 = bwt_pad.reshape(n_words16, 16)
    word_counts = np.stack([(w16 == c).sum(axis=1) for c in range(4)],
                           axis=1)
    word_cum = np.zeros((n_words16, 4), dtype=np.int64)  # exclusive
    np.cumsum(word_counts[:-1], axis=0, out=word_cum[1:])
    block_cum = word_cum[::WORDS]
    occ_sub = (word_cum.reshape(n_blocks, WORDS, 4)
               - block_cum[:, None, :]).astype(np.int8)
    return block_cum.astype(np.int32), occ_sub


def build_fm_arrays(text: np.ndarray, sa_sample: int = 32,
                    sa: np.ndarray | None = None, bi_sample: bool = False):
    """Returns (fm fields, ssa fields) as numpy arrays, equal to
    ``nvbio_tpu.fmindex.build.build_fm_arrays``:
    ((bwt_words (n_blocks, 8) uint32, occ_abs (n_blocks, 4) int32,
    occ_sub (n_blocks, 8, 4) int8, C (5,) int32, primary, n),
    (mark_words uint32, mark_abs int32, vals int32)).

    ``bi_sample`` marks SA values % sa_sample in {0, 1}; the port's
    single-step locate stops at the first mark either way."""
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    if sa is None:
        sa = suffix_array(text)
    m = n + 1  # BWT length including the sentinel slot
    n_blocks = (m + BLOCK - 1) // BLOCK + 1  # +1: queries at i = n + 1
    fused = fm_bwt_occ_native(text, sa)
    if fused is not None:
        bwt_words, occ_abs, occ_sub, primary = fused
    else:
        bwt, primary = bwt_from_sa(text, sa)
        bwt_pad = np.zeros(n_blocks * BLOCK, dtype=np.uint8)
        bwt_pad[:m] = bwt
        bwt_words = pack_2bit(bwt_pad).reshape(n_blocks, WORDS)
        occ_abs, occ_sub = _occ_tables_host(bwt_pad, n_blocks)

    counts = np.bincount(text, minlength=4)
    C = np.zeros(5, dtype=np.int32)
    C[0] = 1  # sentinel
    C[1:] = 1 + np.cumsum(counts)[:4]

    thresh = 2 if bi_sample else 1
    n_words = (n_blocks * BLOCK) // 32
    ssa_t = ssa_build_native(np.asarray(sa), n, sa_sample, thresh, n_words)
    if ssa_t is not None:
        mark_words, mark_abs, vals = ssa_t
    else:
        sa_full = np.empty(m, dtype=np.int64)
        sa_full[0] = n
        sa_full[1:] = sa
        marked = (sa_full % sa_sample) < thresh
        vals = sa_full[marked].astype(np.int32)
        bits = np.zeros(n_words * 32, dtype=bool)
        bits[:m] = marked
        # LSB-first: bit r of word w = bits[32 * w + r]
        mark_words = np.packbits(bits.reshape(n_words, 32), axis=1,
                                 bitorder="little").view("<u4").reshape(
                                     n_words)
        popc = bits.reshape(n_words, 32).sum(axis=1)
        mark_abs = np.zeros(n_words, dtype=np.int32)
        np.cumsum(popc[:-1], out=mark_abs[1:])
    return ((bwt_words, occ_abs, occ_sub, C, np.int32(primary), np.int32(n)),
            (mark_words, mark_abs, vals))


def build_kmer_lut(text: np.ndarray, k: int = 11):
    """k-mer -> SA-range table (lut_lo, lut_hi), each (4^k,) int32: the
    backward search's starting range after its last k symbols.  Ranges
    come from a histogram of suffix keys key2 = packed_prefix * 2 +
    is_full (short suffixes sort first): [1 + #(key2 < 2q), 1 + #(key2
    <= 2q + 1))."""
    if not 1 <= k <= 15:
        raise ValueError("k-mer LUT keys are int32: 1 <= k <= 15")
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    counts = kmer_hist_native(text, k)
    if counts is None:
        padded = np.concatenate([text & 3, np.zeros(k, np.uint8)])
        key = np.zeros(n, np.int64)
        for j in range(k):
            key = (key << 2) | padded[j : j + n]
        key2 = key * 2 + (np.arange(n) <= n - k)
        counts = np.bincount(key2, minlength=2 << (2 * k))
    cum = np.cumsum(counts)
    probes = np.arange(1 << (2 * k), dtype=np.int64) * 2
    return ((cum[probes] + 1).astype(np.int32),
            (cum[probes + 1] + 1).astype(np.int32))
