"""Suffix array construction (host): a copy of ``nvbio_tpu/sufsort/sa.py``.

Two host paths (ref: nvbio/sufsort/sufsort.h — cuda::suffix_sort /
blockwise_suffix_sort; nvbio/sufsort/prefix_doubling_sufsort.h):

- **SA-IS** (native C++, linear time, int32/int64): the workhorse for
  any size up to hg38 fwd+rev concatenations.
- **Prefix-doubling** (vectorized NumPy, O(n log^2 n)): pure-Python
  fallback when no C++ toolchain exists.

The device sorts are ``sufsort.device`` (whole-text prefix doubling,
read-set BWT) and ``sufsort.bucketed`` (the shard-scale chunked sort).
This module imports numpy and the port's native library only, so the
sharded build's pool workers load it without torch; its functions are
the reference's, line for line (tests/test_torch_host_copies.py).

Convention: suffixes compare with the end-of-string sentinel smaller
than every symbol, i.e. the suffix array of T is positions sorted as in
T + '$'.
"""

from __future__ import annotations

import numpy as np


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` (int symbols); shorter-suffix-first
    (sentinel-smallest) comparison convention.

    Dispatches to native SA-IS when the C++ toolchain is available,
    falling back to vectorized prefix doubling.
    """
    t8 = np.asarray(text)
    if t8.size and t8.max() < 256 and t8.min() >= 0:
        from ..native import sais_native

        sa = sais_native(t8.astype(np.uint8, copy=False))
        if sa is not None:
            return sa
    if t8.size > 50_000_000:
        import warnings

        warnings.warn(
            "native SA-IS unavailable (C++ toolchain?): falling back "
            f"to O(n log^2 n) prefix doubling for a {t8.size/1e6:.0f} "
            "Mbp text — expect a VERY long build",
            RuntimeWarning, stacklevel=2)
    return suffix_array_pd(t8)


def suffix_array_pd(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling (Manber-Myers) suffix array, vectorized NumPy."""
    t = np.asarray(text, dtype=np.int64)
    n = len(t)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = t.copy()
    k = 1
    tmp = np.empty(n, dtype=np.int64)
    while True:
        # key = (rank[i], rank[i+k]) with -1 past the end
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
        if tmp[n - 1] == n - 1:
            return sa
        k *= 2
        if k >= n:
            return sa


def bwt_from_sa(text: np.ndarray, sa: np.ndarray):
    """BWT of text + sentinel.

    Returns (bwt, primary): `bwt` is the length n+1 symbol array of
    T+'$' rotations sorted, with the sentinel's slot (row `primary`)
    holding symbol 0 ('A'); occ/rank users must subtract the sentinel
    adjustment (see fmindex.occ).  Row 0 of the conceptual matrix is the
    '$' suffix, so bwt[0] = text[-1].
    """
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    assert n < (1 << 32) - 1, "per-shard texts are < 4 Gbp"
    primary = int(np.flatnonzero(sa == 0)[0]) + 1
    bwt = np.empty(n + 1, dtype=np.uint8)
    bwt[0] = text[n - 1]  # row 0 is the '$' suffix
    # chunked uint32 gather (half the index traffic of int64; the
    # boolean-mask formulation cost 3 extra full passes)
    CH = 1 << 24
    for s0 in range(1, n + 1, CH):
        sl = sa[s0 - 1 : s0 - 1 + CH].astype(np.uint32)
        np.subtract(sl, 1, out=sl)  # sa == 0 wraps; overwritten below
        np.minimum(sl, n - 1, out=sl)
        bwt[s0 : s0 + CH] = text[sl]
    bwt[primary] = 0  # dummy 'A' in the sentinel slot
    return bwt, primary
