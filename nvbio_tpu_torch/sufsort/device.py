"""On-device suffix sorting with ``torch.sort``.

Port of ``nvbio_tpu/sufsort/device.py`` (ref: nvbio/sufsort/sufsort.h —
``cuda::suffix_sort``, ``prefix_doubling_sufsort.h`` —
``PrefixDoublingSufSort``, and ``bwte.h`` — the set-BWT of read
collections, the algorithm of arXiv:1410.0562):

- ``suffix_array_device``: prefix doubling over the whole text, one
  stable sort a round with early exit — the suffix array of a reference
  that fits device memory.
- ``set_bwt_device``: the BWT of a *set* of short reads.  Read suffixes
  are bounded by the read length, so the sort is a fixed number of LSD
  radix rounds over packed 8-symbol words.

The reference's two-key ``lax.sort`` becomes one stable ``torch.sort``
of an int64 composite key (first key in the high 32 bits), which orders
the payload the same way.  Word packing runs in int64: torch has no
shifts on uint32.  Every function runs on the ``device`` it is given;
the outputs are numpy and equal the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _pd_round(rank, k):
    """One prefix-doubling round: re-rank by (rank[i], rank[i+k]), the
    second -1 past the end.  ``rank`` is int64; returns (new_rank, sa,
    done)."""
    n = rank.shape[0]
    second = torch.full_like(rank, -1)
    second[: n - k] = rank[k:]
    key_s, sa = torch.sort((rank << 32) | (second + 1), stable=True)
    new_rank_sorted = torch.zeros_like(rank)
    new_rank_sorted[1:] = torch.cumsum(key_s[1:] != key_s[:-1], 0)
    new_rank = torch.empty_like(rank)
    new_rank[sa] = new_rank_sorted
    return new_rank, sa, new_rank_sorted[-1] == n - 1


def suffix_array_device(text: np.ndarray, device="cuda") -> np.ndarray:
    """Suffix array of `text` (symbols, n < 2^31) computed on
    ``device``; sentinel-smallest convention, identical output to
    ``sufsort.suffix_array``."""
    dev = resolve_device(device)
    t = np.asarray(text)
    n = int(t.shape[0])
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = torch.from_numpy(t.astype(np.int64)).to(dev)
    k = 1
    while True:
        rank, sa, done = _pd_round(rank, k)
        k *= 2
        if bool(done) or k >= n:  # one host sync a round, as the reference
            return sa.cpu().numpy().astype(np.int64)


def _pack_words(symp_flat, offs, w, stride_mask):
    """Pack 8 symbols starting at offs+8w into the low 32 bits of an
    int64 (4 bits each, first symbol highest); 0xFFFFFFFF where
    ``stride_mask`` (invalid suffixes), above every packed word."""
    word = torch.zeros_like(offs)
    base = offs + 8 * w
    for j in range(8):
        word = (word << 4) | symp_flat[base + j].long()
    return word.masked_fill(stride_mask, 0xFFFFFFFF)


def set_bwt_device(reads: np.ndarray, lens: np.ndarray, device="cuda"):
    """BWT of a read set (BCR/bwte-style) computed on ``device``.

    `reads`: (R, Lmax) symbols 0..3; `lens`: (R,).  Returns the BWT
    symbol array (length sum(lens)+R) over alphabet {0..3, 4='$'}:
    suffixes of every read (each read followed by its own sentinel,
    sentinels ordered by read id) sorted; entry = preceding symbol,
    with 4 marking read starts.

    Suffix offsets are int64 (the reference's int32 offsets wrap once
    R * stride reaches 2^31, ~10.5 M reads of 100 bp)."""
    dev = resolve_device(device)
    reads = np.asarray(reads, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int32)
    R, Lmax = reads.shape
    L1 = Lmax + 1
    n_words = (L1 + 7) // 8

    # shifted symbols (+1), 0 = sentinel/pad, laid out with 8-word slack
    stride = L1 + 8 * n_words
    symp = np.zeros((R, stride), dtype=np.uint8)
    for r_chunk in range(0, R, 1 << 16):
        sl = slice(r_chunk, min(R, r_chunk + (1 << 16)))
        block = reads[sl].astype(np.uint8) + 1
        mask = np.arange(Lmax)[None, :] < lens[sl, None]
        symp[sl, :Lmax] = np.where(mask, block, 0)

    symp_d = torch.from_numpy(symp.reshape(-1)).to(dev)
    sid = torch.arange(R * L1, device=dev)
    suf_r, suf_o = sid // L1, sid % L1
    invalid = suf_o > torch.from_numpy(lens).to(dev).long()[suf_r]
    offs = suf_r * stride + suf_o
    del sid, suf_r, suf_o
    # least-significant key first: suffix id order (read id then
    # offset, the sentinel tie-break) is the start, then words
    # w = n_words-1 .. 0; offsets and flags ride in sorted order
    for w in range(n_words - 1, -1, -1):
        keys = _pack_words(symp_d, offs, w, invalid)
        _, order = torch.sort(keys, stable=True)
        offs, invalid = offs[order], invalid[order]
    # BWT symbol = preceding symbol; read start (offset 0) -> 4 ('$');
    # at offs 0 the gather wraps to the last byte, which is discarded
    prev = symp_d[offs - 1].long() - 1  # -1 undoes the shift
    bwt = torch.where(offs % stride == 0, 4, prev)
    return bwt[~invalid].to(torch.uint8).cpu().numpy()


def set_bwt_oracle(reads: np.ndarray, lens: np.ndarray):
    """Naive host set-BWT (sorted-suffix oracle) for tests."""
    reads = np.asarray(reads, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    sufs = []
    for r in range(reads.shape[0]):
        seq = [int(c) + 1 for c in reads[r, : lens[r]]] + [0]
        for o in range(len(seq)):
            sufs.append((seq[o:], r, o))
    sufs.sort(key=lambda x: (x[0], x[1]))
    out = []
    for seq_suffix, r, o in sufs:
        if o == 0:
            out.append(4)
        else:
            full = [int(c) + 1 for c in reads[r, : lens[r]]] + [0]
            out.append(full[o - 1] - 1)
    return np.asarray(out, dtype=np.uint8)
