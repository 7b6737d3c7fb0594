"""Q-gram index: sorted (key, position) arrays + batched filter, in
PyTorch.

Port of ``nvbio_tpu/qgram/index.py``.  The index is built on the host
(``qgram_keys``, the reference's NumPy function), in the order of the
reference's stable argsort: equal keys keep ascending positions, so the
filter's first ``max_hits`` rows of a key are the reference's.  It is
uploaded as int32 keys and positions: 8 bytes a genome position.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: the diagonal of a filter slot with no hit
NO_DIAG = -(1 << 30)


@dataclass
class QGramIndex:
    q: int  # gram length
    keys: torch.Tensor  # (m,) int32 sorted q-gram keys
    pos: torch.Tensor  # (m,) int32 text position of each key


def qgram_keys(text: np.ndarray, q: int) -> np.ndarray:
    """Rolling 2-bit keys of every length-q window (host, vectorized).

    Keys are int32 (q <= 15 at 2 bits a symbol)."""
    if q > 15:
        raise ValueError("q-gram keys are int32: q <= 15")
    text = np.asarray(text, dtype=np.int32) & 3
    n = len(text) - q + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int32)
    keys = np.zeros(n, dtype=np.int32)
    for j in range(q):  # q is small; windows are vectorized
        keys = (keys << 2) | text[j : j + n]
    return keys


def build_qgram_index(text: np.ndarray, q: int = 12,
                      device="cpu") -> QGramIndex:
    """The index of ``text`` (unpadded genome symbols) on ``device``."""
    keys = qgram_keys(text, q)
    # (key, position) pairs packed into unique int64s: one plain sort
    # gives the stable argsort's order (a 64 Mbp genome sorts ~10x
    # faster than a stable argsort of the int32 keys)
    pairs = np.sort((keys.astype(np.int64) << 32)
                    | np.arange(len(keys), dtype=np.int64))
    return QGramIndex(
        q=q,
        keys=torch.from_numpy((pairs >> 32).astype(np.int32)).to(device),
        pos=torch.from_numpy((pairs & 0xFFFFFFFF).astype(np.int32)).to(device))


def qgram_filter(index: QGramIndex, queries, offsets, max_hits: int):
    """Batched q-gram lookup with diagonal output.

    queries: (N,) keys (one per extracted read q-gram); offsets: (N,)
    read offset of each q-gram.  Returns (diag, valid): (N, max_hits)
    int32 candidate text diagonals (hit position - offset, NO_DIAG where
    invalid) and the validity mask."""
    queries = queries.to(index.keys.dtype).contiguous()
    lo = torch.searchsorted(index.keys, queries, side="left")
    hi = torch.searchsorted(index.keys, queries, side="right")
    t = torch.arange(max_hits, device=queries.device)
    rows = lo[:, None] + t
    valid = rows < hi[:, None]
    rows = rows.clamp(0, max(index.pos.shape[0] - 1, 0))
    diag = index.pos[rows] - offsets[:, None].to(torch.int32)
    return torch.where(valid, diag, NO_DIAG), valid
