"""Bucketed device suffix sort: device memory bounded by a chunk.

Port of ``nvbio_tpu/sufsort/bucketed.py`` (the capability of the
reference's blockwise difference-cover sort — nvbio/sufsort/dcs.h +
compression_sort.h — re-thought for key-based sorts):

1. **Host bucketing** (one linear pass): every suffix keyed by its
   first 8 symbols (base-5, end-of-string = 0 so the sentinel sorts
   smallest); a stable integer argsort groups suffixes into at most
   5^8 contiguous buckets.  A suffix's global rank is its bucket's
   start index, so all later work is bucket-local.

2. **Device radix refinement** (per chunk of whole buckets, <=
   chunk_cap suffixes): rounds of one stable sort by (rank,
   next-8-symbols).  The 8-symbol window at any offset is two gathers
   and a funnel shift from the nibble-packed text (symbol+1 per
   nibble, 0 = past-end, first symbol highest, so numeric order is
   lexicographic order) — the packed text is the only full-length
   device array (0.5 B/bp, kept as int32 bits).  The relabel keeps
   ranks globally consistent: new rank = old rank (its group's global
   start) + index-within-group of the segment head, two ``cummax``
   passes.  A chunk stops as soon as nothing ties (random text: ~2
   rounds); repeat-dense buckets continue to ``v`` symbols.

3. **Compacted global doubling** for whatever still ties after ``v``
   symbols (high-copy repeats): Larsson–Sadakane rounds ``key =
   (rank[p], rank[p+k])``, k = v, 2v, ..., over the surviving groups
   only, with ``rank[p+k]`` gathered on the host from the global rank
   array (-1 past the end).

The reference's two-key ``lax.sort`` is one stable ``torch.sort`` of an
int64 composite key (rank in the high 32 bits); the 32-bit window
arithmetic runs in int64 masked to 32 bits, as torch has no uint32
shifts.  The reference pads each chunk to a power of two so that few
XLA executables serve every chunk; its pads sort last and never change
a result, and torch needs no fixed shapes, so chunks here are their own
size.  Device work runs on the ``device`` given; one host sync a round
(the tie count), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# default refinement depth before switching to doubling: 8 host + 7
# device rounds x 8 symbols; repeats with period <= 64 are the common
# genomic case (ALU ~300 bp handled by doubling in 5 more rounds)
V_SYMBOLS = 64
CHUNK_CAP = 1 << 23  # suffixes per device chunk
INT_MAX = 2**31 - 1
MASK32 = 0xFFFFFFFF


def _pack_nibbles(text: np.ndarray, pad_words: int) -> np.ndarray:
    """(sym+1) 4-bit nibbles, 8 per u32, first symbol in the top
    nibble (numeric u32 order == lexicographic symbol order), plus
    `pad_words` zero words so windows may read past the end."""
    n = len(text)
    n_words = (n + 7) // 8
    nib = np.zeros(n_words * 8, dtype=np.uint32)
    nib[:n] = text.astype(np.uint32) + 1
    w = nib.reshape(n_words, 8)
    packed = np.zeros(n_words + pad_words, dtype=np.uint32)
    for j in range(8):
        packed[:n_words] |= w[:, j] << (28 - 4 * j)
    return packed


def _host_bucket_keys(text: np.ndarray) -> np.ndarray:
    """Base-5 key of the first 8 (sym+1)-biased symbols, 0 past end."""
    n = len(text)
    padded = np.zeros(n + 8, dtype=np.int32)
    padded[:n] = text.astype(np.int32) + 1
    key = np.zeros(n, dtype=np.int32)
    for j in range(8):
        key *= 5
        key += padded[j : j + n]
    return key


def _relabel(rank_s, key_s):
    """(new_rank, tied) of a run sorted by (rank, key): each element
    takes its segment head's rank + index within its old group; tied =
    shares its segment with a neighbour and is not a pad."""
    m = rank_s.shape[0]
    one = torch.ones(1, dtype=torch.bool, device=rank_s.device)
    grp_new = torch.cat([one, rank_s[1:] != rank_s[:-1]])
    seg_new = grp_new | torch.cat([one, key_s[1:] != key_s[:-1]])
    idx = torch.arange(m, device=rank_s.device)
    # index within the (old) group
    in_grp = idx - torch.cummax(torch.where(grp_new, idx, 0), 0).values
    # the head's (rank + in-group index) is strictly increasing over
    # segment heads (group slots are globally disjoint), so one cummax
    # broadcasts it over the segment
    new_rank = torch.cummax(torch.where(seg_new, rank_s + in_grp, -1),
                            0).values
    seg_sz_gt1 = ~seg_new | torch.cat([~seg_new[1:], ~one])
    return new_rank, seg_sz_gt1 & (rank_s != INT_MAX)


def _refine_round(packed, rank, pos, off_words):
    """One symbol-refinement round: sort by (rank, the 8 symbols at
    pos + 8*off_words), relabel.  ``packed`` holds the nibble words as
    int32 bits; ``rank`` and ``pos`` are int64.  Returns (new_rank,
    new_pos, n_tied) with ranks globally consistent."""
    q = pos + 8 * off_words
    a = q >> 3
    r4 = (q & 7) << 2  # nibble shift in bits
    hi = ((packed[a].long() & MASK32) << r4) & MASK32
    lo = ((packed[a + 1].long() & MASK32) >> (31 - r4)) >> 1
    w = hi | lo
    _, order = torch.sort((rank << 32) | w, stable=True)
    rank_s, w_s, pos_s = rank[order], w[order], pos[order]
    new_rank, tied = _relabel(rank_s, w_s)
    return new_rank, pos_s, tied.sum()


def _double_round(rank, second, pos):
    """One compacted Larsson–Sadakane round over surviving groups:
    sort by (rank, rank[p+k]) (second gathered on host, -1 past the
    end), relabel."""
    _, order = torch.sort((rank << 32) | (second + 1), stable=True)
    rank_s, sec_s, pos_s = rank[order], second[order], pos[order]
    new_rank, tied = _relabel(rank_s, sec_s)
    return new_rank, pos_s, tied


def suffix_array_bucketed(text: np.ndarray, v: int = V_SYMBOLS,
                          chunk_cap: int = CHUNK_CAP,
                          verbose: bool = False,
                          device="cuda") -> np.ndarray:
    """Suffix array of `text` (uint8 symbols 0..3), device-sorted in
    chunks on ``device``; identical output to ``sufsort.suffix_array``
    (sentinel-smallest convention)."""
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    if n < 4096:  # not worth a device round trip
        from .sa import suffix_array_pd
        return suffix_array_pd(text)
    assert v % 8 == 0 and v >= 16
    dev = resolve_device(device)

    # ---- phase 1: host bucketing by the first 8 symbols ----
    key8 = _host_bucket_keys(text)
    order = np.argsort(key8, kind="stable").astype(np.int32)
    key_sorted = key8[order]
    del key8
    grp_start_mask = np.empty(n, dtype=bool)
    grp_start_mask[0] = True
    np.not_equal(key_sorted[1:], key_sorted[:-1], out=grp_start_mask[1:])
    del key_sorted
    # global rank of each position in `order`-order = its group start
    starts_idx = np.flatnonzero(grp_start_mask).astype(np.int32)
    grp_id = np.cumsum(grp_start_mask) - 1
    rank_in_order = starts_idx[grp_id].astype(np.int32)
    del grp_id

    rank_final = np.empty(n, dtype=np.int32)  # rank by position
    rank_final[order] = rank_in_order

    pad_words = (v + 80) // 8 + 2
    packed = torch.from_numpy(
        _pack_nibbles(text, pad_words).view(np.int32)).to(dev)

    # chunks = runs of whole buckets, <= chunk_cap suffixes each (a
    # single bucket larger than chunk_cap gets its own chunk)
    bucket_bounds = np.append(starts_idx, n)
    chunks = []
    c0 = 0
    for b in range(len(starts_idx)):
        if bucket_bounds[b + 1] - c0 > chunk_cap and bucket_bounds[b] > c0:
            chunks.append((c0, int(bucket_bounds[b])))
            c0 = int(bucket_bounds[b])
    chunks.append((c0, n))

    # ---- phase 2: device radix refinement to v symbols ----
    rounds_sym = (v - 8) // 8
    for ci, (s, e) in enumerate(chunks):
        m = e - s
        # singleton-only chunk: already resolved by the host key
        if m == np.sum(grp_start_mask[s:e]):
            continue
        jr = torch.from_numpy(rank_in_order[s:e]).to(dev).long()
        jp = torch.from_numpy(order[s:e]).to(dev).long()
        for r in range(1, rounds_sym + 1):
            jr, jp, n_tied = _refine_round(packed, jr, jp, r)
            if int(n_tied) == 0:
                break
        rank_in_order[s:e] = jr.cpu().numpy()
        order[s:e] = jp.cpu().numpy()
        if verbose:
            print(f"[sufsort] chunk {ci}: {m} suffixes, "
                  f"{int(n_tied)} tied after {r * 8 + 8} symbols",
                  flush=True)
    rank_final[order] = rank_in_order

    # ---- phase 3: compacted doubling over surviving ties ----
    seg_new = np.empty(n, dtype=bool)
    seg_new[0] = True
    np.not_equal(rank_in_order[1:], rank_in_order[:-1], out=seg_new[1:])
    tied_mask = ~seg_new | np.append(~seg_new[1:], False)
    k = v
    while tied_mask.any() and k < n:
        act = np.flatnonzero(tied_mask)
        m = len(act)
        pos_act = order[act]
        pk = pos_act.astype(np.int64) + k
        sec = np.where(pk < n, rank_final[np.minimum(pk, n - 1)], -1)
        jr, jp, jt = _double_round(
            torch.from_numpy(rank_in_order[act]).to(dev).long(),
            torch.from_numpy(sec.astype(np.int64)).to(dev),
            torch.from_numpy(pos_act).to(dev).long())
        new_rank = jr.cpu().numpy().astype(np.int32)
        new_pos = jp.cpu().numpy().astype(np.int32)
        still = jt.cpu().numpy()
        # `act` indexes stay the sorted slots of these suffixes (the
        # sort permutes within equal-rank groups, which occupy
        # contiguous `act` runs — each group is whole in the active
        # set by construction)
        rank_in_order[act] = new_rank
        order[act] = new_pos
        rank_final[new_pos] = new_rank
        tied_mask[:] = False
        tied_mask[act[still]] = True
        if verbose:
            print(f"[sufsort] doubling k={k}: {m} active, "
                  f"{int(still.sum())} still tied", flush=True)
        k *= 2
    assert not tied_mask.any(), "doubling did not converge"

    sa = np.empty(n, dtype=np.int64)
    sa[:] = order
    return sa
