"""Wavelet tree: rank dictionary for alphabets beyond 2-bit DNA.

Port of ``nvbio_tpu/strings/wavelet.py`` (ref: nvbio/strings/
wavelet_tree.h ``WaveletTree``, ``rank()``), the rank dictionary of the
protein FM-index (``fmindex/wavelet_fm.py``).

Layout: ``levels`` bit-planes (ceil(log2(sigma))), each a bitvector of
length n stored as 32-bit words plus a blocked popcount prefix (rank1 in
O(1)).  At level l the sequence is stably partitioned by bit l-1's
outcome, classic wavelet-tree construction; per-level node boundaries
are implicit in ``node_start``/``node_ones`` tables (<= 2^l nodes).

The build is the reference's host code (NumPy), its arrays moved to a
torch device; queries are batched torch gathers, O(levels) per query,
each level one word gather and a popcount (``fmindex.index.popcount32``).
The words keep their uint32 values in int64 tensors, so no shift
sign-extends.  A word index past the last word reads the last word, as
the reference's clamped JAX gather does (``_rank1_level``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fmindex.index import popcount32


class WaveletTree(NamedTuple):
    # per level: bit-plane bitvector + blocked rank
    words: torch.Tensor  # (levels, n_words) int64 holding uint32 words
    block_rank: torch.Tensor  # (levels, n_words) int64 exclusive 1-count
    node_start: torch.Tensor  # (levels, n_nodes) int64 node offsets
    node_ones: torch.Tensor  # (levels, n_nodes) int64 ones inside node
    n: int  # sequence length
    levels: int
    sigma: int


def _build_host(seq: np.ndarray, sigma: int):
    """The reference's host construction (``build_wavelet_tree``):
    (words uint32, block_rank, node_start, node_ones int32, levels)."""
    seq = np.asarray(seq, dtype=np.int32)
    n = len(seq)
    levels = max(1, int(np.ceil(np.log2(max(sigma, 2)))))
    n_nodes = 1 << (levels - 1)
    n_words = max(1, (n + 31) // 32)

    words = np.zeros((levels, n_words), dtype=np.uint32)
    block_rank = np.zeros((levels, n_words), dtype=np.int32)
    node_start = np.zeros((levels, n_nodes), dtype=np.int32)
    node_ones = np.zeros((levels, n_nodes), dtype=np.int32)

    cur = seq
    # starts of the nodes at the current level (there are 2^l of them)
    starts = [0]
    for l in range(levels):
        bit = (cur >> (levels - 1 - l)) & 1
        # record bit-plane
        bits = np.zeros(n_words * 32, dtype=bool)
        bits[:n] = bit.astype(bool)
        packed = np.packbits(bits.reshape(n_words, 32), axis=1,
                             bitorder="little")
        words[l] = packed.view("<u4")[:, 0]
        popc = bits.reshape(n_words, 32).sum(axis=1)
        block_rank[l, 1:] = np.cumsum(popc[:-1])
        # node tables for this level
        for k, s in enumerate(starts):
            e = starts[k + 1] if k + 1 < len(starts) else n
            node_start[l, k] = s
            node_ones[l, k] = int(bit[s:e].sum())
        # stable partition inside each node for the next level
        if l + 1 < levels:
            nxt = np.empty_like(cur)
            new_starts = []
            for k, s in enumerate(starts):
                e = starts[k + 1] if k + 1 < len(starts) else n
                seg = cur[s:e]
                b = bit[s:e]
                z = seg[b == 0]
                o = seg[b == 1]
                nxt[s : s + len(z)] = z
                nxt[s + len(z) : e] = o
                new_starts.extend([s, s + len(z)])
            cur = nxt
            starts = new_starts
    return words, block_rank, node_start, node_ones, levels


def build_wavelet_tree(seq: np.ndarray, sigma: int,
                       device="cpu") -> WaveletTree:
    """Host construction from int symbols in [0, sigma); the tree's
    tensors on ``device``."""
    words, block_rank, node_start, node_ones, levels = _build_host(seq,
                                                                   sigma)

    def t(a):
        return torch.from_numpy(a.astype(np.int64)).to(device)

    return WaveletTree(words=t(words), block_rank=t(block_rank),
                       node_start=t(node_start), node_ones=t(node_ones),
                       n=len(seq), levels=levels, sigma=sigma)


def _rank1_level(words_l, block_l, i):
    """# of set bits among the first i bits of level bitvector (a word
    index past the end reads the last word, as the reference's gather
    clamps)."""
    w = (i >> 5).clamp(max=words_l.shape[0] - 1)
    r = i & 31
    mask = (torch.ones_like(r) << r) - 1
    return block_l[w] + popcount32(words_l[w] & mask)


def wt_rank(wt: WaveletTree, c, i):
    """rank(c, i): occurrences of symbol c in seq[0:i).  c, i: integer
    tensors of one shape; vectorized over elements.  Returns int64."""
    c = c.to(torch.int64)
    pos = i.to(torch.int64)
    node = torch.zeros_like(c)
    for l in range(wt.levels):
        bit = (c >> (wt.levels - 1 - l)) & 1
        s = wt.node_start[l][node]
        ones_before = (_rank1_level(wt.words[l], wt.block_rank[l], s + pos)
                       - _rank1_level(wt.words[l], wt.block_rank[l], s))
        pos = torch.where(bit == 1, ones_before, pos - ones_before)
        if l + 1 < wt.levels:
            # child node index at the next level
            node = 2 * node + bit
    return pos


def wt_access(wt: WaveletTree, i):
    """seq[i] reconstructed from the bit-planes (batched).  Returns
    int64."""
    pos = i.to(torch.int64)
    node = torch.zeros_like(pos)
    sym = torch.zeros_like(pos)
    for l in range(wt.levels):
        s = wt.node_start[l][node]
        gi = s + pos
        bit = (wt.words[l][gi >> 5] >> (gi & 31)) & 1
        ones_before = (_rank1_level(wt.words[l], wt.block_rank[l], gi)
                       - _rank1_level(wt.words[l], wt.block_rank[l], s))
        sym = (sym << 1) | bit
        pos = torch.where(bit == 1, ones_before, pos - ones_before)
        if l + 1 < wt.levels:
            node = 2 * node + bit
    return sym
