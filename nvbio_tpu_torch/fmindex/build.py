"""FM-index construction: numpy + the native C++ library, and the occ
tables on a torch device on request.

Port of ``nvbio_tpu/fmindex/build.py`` (``occ_tables_device`` ``:60``,
``build_fm_arrays`` ``:106``, ``build_kmer_lut`` ``:220``), which
imports JAX: the same arrays, from the same native passes (the port's
copy ``nvbio_tpu_torch.native``: SA-IS, the fused BWT + occ pass, the
SSA pass, the k-mer histogram), with the same numpy fallbacks when the
native library cannot be built.  torch is imported only by
``occ_tables_device``: the sharded build's pool workers load this
module without it.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..basic.packed import pack_2bit
from ..native import fm_bwt_occ_native, kmer_hist_native, ssa_build_native
from ..sufsort.sa import bwt_from_sa, suffix_array

BLOCK = 128  # symbols per occ block (the native pass hardcodes it)
WORDS = BLOCK // 16


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


# 2^20 occ blocks (128 Mbp of BWT) per device call: the in-flight
# working set (word counts and their cumsum) stays O(chunk), whatever
# the shard's size
OCC_CHUNK_BLOCKS = 1 << 20
MASK32 = 0xFFFFFFFF


def _popc32(x):
    """Popcount of the low 32 bits of int64 ``x`` (SWAR; the byte sum
    is read from bits 24..31 of the product)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def occ_tables_device(bwt_words: np.ndarray, device="cuda"):
    """Blocked occ tables computed on ``device`` from the packed BWT
    words ((n_blocks, WORDS) uint32, 16 2-bit symbols each): popcounts
    per word and symbol, then a cumsum in OCC_CHUNK_BLOCKS-block chunks
    with a (4,) running carry.  Upload = the packed BWT (0.25 B/symbol,
    as int32 bits); download = occ_abs (int32 (n_blocks, 4)) + occ_sub
    (int8 (n_blocks, WORDS, 4)).  Equal to ``_occ_tables_host``."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    n_blocks = bwt_words.shape[0]
    words = np.ascontiguousarray(bwt_words, dtype=np.uint32).view(np.int32)
    occ_abs = np.empty((n_blocks, 4), dtype=np.int32)
    occ_sub = np.empty((n_blocks, WORDS, 4), dtype=np.int8)
    carry = torch.zeros(4, dtype=torch.int64, device=dev)
    CH = OCC_CHUNK_BLOCKS
    for s in range(0, n_blocks, CH):
        e = min(s + CH, n_blocks)
        w = torch.from_numpy(words[s:e]).to(dev).reshape(-1).long() & MASK32
        b0 = w & 0x55555555
        b1 = (w >> 1) & 0x55555555
        c3 = _popc32(b0 & b1)
        c1 = _popc32(b0 & ~b1)
        c2 = _popc32(b1 & ~b0)
        wc = torch.stack([16 - c1 - c2 - c3, c1, c2, c3], dim=1)
        cum = torch.cumsum(wc, 0) - wc + carry  # exclusive, carried
        carry = cum[-1] + wc[-1]
        cum = cum.reshape(e - s, WORDS, 4)
        block_cum = cum[:, 0]
        occ_abs[s:e] = block_cum.to(torch.int32).cpu().numpy()
        occ_sub[s:e] = (cum - block_cum[:, None]).to(torch.int8).cpu().numpy()
    return occ_abs, occ_sub


def build_fm_arrays(text: np.ndarray, sa_sample: int = 32,
                    sa: np.ndarray | None = None, bi_sample: bool = False,
                    occ_device: bool = False, device="cuda"):
    """Returns (fm fields, ssa fields) as numpy arrays, equal to
    ``nvbio_tpu.fmindex.build.build_fm_arrays``:
    ((bwt_words (n_blocks, 8) uint32, occ_abs (n_blocks, 4) int32,
    occ_sub (n_blocks, 8, 4) int8, C (5,) int32, primary, n),
    (mark_words uint32, mark_abs int32, vals int32)).

    ``bi_sample`` marks SA values % sa_sample in {0, 1}; the port's
    single-step locate stops at the first mark either way.
    ``occ_device`` skips the fused native pass: BWT, 2-bit packing, then
    the occ tables on ``device`` (occ_tables_device); ``device`` is
    used only then."""
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    if sa is None:
        sa = suffix_array(text)
    m = n + 1  # BWT length including the sentinel slot
    n_blocks = (m + BLOCK - 1) // BLOCK + 1  # +1: queries at i = n + 1
    fused = None if occ_device else fm_bwt_occ_native(text, sa)
    if fused is not None:
        bwt_words, occ_abs, occ_sub, primary = fused
    else:
        bwt, primary = bwt_from_sa(text, sa)
        bwt_pad = np.zeros(n_blocks * BLOCK, dtype=np.uint8)
        bwt_pad[:m] = bwt
        bwt_words = pack_2bit(bwt_pad).reshape(n_blocks, WORDS)
        if occ_device:
            occ_abs, occ_sub = occ_tables_device(bwt_words, device)
        else:
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


def build_shard_arrays(args, occ_device=False, device="cuda"):
    """One shard of ``fmindex.sharded.build_sharded_index``: (fm fields,
    ssa fields, lut or None) as numpy arrays, for ``args`` = (segment,
    start, sa_sample, lut_k, bi_sample).  Without ``occ_device`` it
    needs only numpy and the native library, so a spawned pool worker
    that runs it never loads torch or touches a GPU."""
    seg, start, sa_sample, lut_k, bi_sample = args
    seg = np.ascontiguousarray(seg, dtype=np.uint8)
    t0 = time.time()
    sa = suffix_array(seg)
    t1 = time.time()
    fm_fields, ssa_fields = build_fm_arrays(seg, sa_sample=sa_sample, sa=sa,
                                            bi_sample=bi_sample,
                                            occ_device=occ_device,
                                            device=device)
    del sa
    t2 = time.time()
    lut = build_kmer_lut(seg, k=lut_k) if lut_k > 0 else None
    t3 = time.time()
    if len(seg) >= 50_000_000:  # the stage table only at real scale
        print(f"[build_index] shard @{start}: {len(seg) / 1e6:.0f} Mbp  sa "
              f"{t1 - t0:.1f}s  bwt+occ{'(dev)' if occ_device else ''}+ssa "
              f"{t2 - t1:.1f}s  lut "
              f"{t3 - t2:.1f}s", file=sys.stderr, flush=True)
    return fm_fields, ssa_fields, lut
