"""Bloom filters and count-min sketches as torch ops.

Port of ``nvbio_tpu/basic/bloom.py`` (ref: nvbio/basic/bloom_filter.h
``bloom_filter``, ``blocked_bloom_filter``), the backing store of the
nvLighter-style corrector (``models/corrector.py``).  One byte per slot,
scatter-max inserts and gather queries, as in the reference; no kernel
stands behind any of it there either.  Slot count is a power of two.

The hash is the reference's uint32 xorshift-multiply finalizer, done in
int64 with each 32-bit product taken from 16-bit halves so that no
intermediate passes 2^49: keys of any integer dtype hash as their low 32
bits, as ``astype(uint32)`` gives them.  The hashes of one call are
computed together, one row a hash function.  The counting insert is a
``bincount`` of the kept slot indices, cut to its low byte and added in
uint8, which wraps mod 256 as the reference's uint8 ``.at[].add`` does:
exact and deterministic on either device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_M32 = 0xFFFFFFFF
_SALTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
          0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for uint32 values x in int64 and a constant c."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix(x, salt):
    """xorshift-multiply finalizer (splitmix-style) on uint32 values:
    the low 32 bits of ``x`` xor ``salt`` (an int or an int64 tensor
    that broadcasts), returned as int64 in [0, 2^32)."""
    x = (x.to(torch.int64) & _M32) ^ salt
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


class BloomFilter(NamedTuple):
    slots: torch.Tensor  # (n_slots,) uint8, n_slots = 2**log2_slots
    n_hashes: int


def make_bloom(log2_slots: int, n_hashes: int = 4,
               device="cpu") -> BloomFilter:
    return BloomFilter(slots=torch.zeros(1 << log2_slots, dtype=torch.uint8,
                                         device=device), n_hashes=n_hashes)


def _slot_index(bf: BloomFilter, keys):
    """(n_hashes, keys.numel()) int64 slot indices of the flattened keys,
    one row a hash function."""
    salts = torch.tensor(_SALTS[: bf.n_hashes], dtype=torch.int64,
                         device=keys.device)[:, None]
    return _mix(keys.reshape(1, -1), salts) & (bf.slots.shape[0] - 1)


def bloom_insert(bf: BloomFilter, keys) -> BloomFilter:
    """Insert integer keys (any shape); returns the updated filter."""
    idx = _slot_index(bf, keys).reshape(-1)
    slots = bf.slots.scatter_reduce(0, idx, torch.ones_like(
        idx, dtype=torch.uint8), reduce="amax")
    return BloomFilter(slots=slots, n_hashes=bf.n_hashes)


def bloom_query(bf: BloomFilter, keys):
    """Membership test; returns bool array shaped like keys."""
    hit = bf.slots[_slot_index(bf, keys)] > 0
    return hit.all(dim=0).reshape(keys.shape)


def counting_insert(bf: BloomFilter, keys, weights=None) -> BloomFilter:
    """Count-min-sketch insert: each hash slot accumulates occurrence
    counts (uint8, wrapping mod 256 as the reference's; callers keep
    coverage < 255).  `weights` masks out invalid keys (0 = skip; the
    reference adds the weight, so weights are 0 or 1)."""
    n_slots = bf.slots.shape[0]
    idx = _slot_index(bf, keys)
    if weights is not None:
        keep = weights.reshape(1, -1) != 0
        # skipped keys land in one extra bin, dropped below (no host sync)
        idx = torch.where(keep, idx, n_slots)
    counts = torch.bincount(idx.reshape(-1), minlength=n_slots + 1)[:n_slots]
    slots = bf.slots + counts.bitwise_and_(255).to(torch.uint8)
    return BloomFilter(slots=slots, n_hashes=bf.n_hashes)


def counting_query(bf: BloomFilter, keys):
    """Count-min estimate: min slot count over the hash functions
    (uint8, shaped like keys)."""
    cnt = bf.slots[_slot_index(bf, keys)].amin(dim=0)
    return cnt.reshape(keys.shape)
