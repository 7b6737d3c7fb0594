"""K-mer-spectrum read error correction (nvLighter equivalent).

Port of ``nvbio_tpu/models/corrector.py`` (ref: nvLighter/, SURVEY.md
§3.9, §4.5): a re-build of the Lighter corrector.  Pass 1 counts every
read k-mer into a count-min sketch (``basic/bloom.py``); pass 2 marks a
k-mer *trusted* when its min-count reaches ``min_count``, calls a base
suspect when no trusted k-mer covers it, evaluates every (suspect
position, alternative base) pair at once by how many covering k-mers it
makes trusted, and applies the best substitution where it reaches
``min_support``.  ``rounds`` > 1 re-runs the sweep on the corrected
output, with one host check a round.

Torch ops on the reads' device, the reference's arithmetic throughout:
int32 k-mer keys (2 bits a base, k <= 15), the four alternative bases
evaluated in one stacked query, ``torch.argmax``'s first maximal index
for ``jnp.argmax``'s.  The reference evaluates every position and masks
the non-suspects out; the port compacts the suspects first (one host
sync a call), which gives the same corrections.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..basic.bloom import (
    BloomFilter,
    make_bloom,
    counting_insert,
    counting_query,
)


def _kmer_keys(reads, k: int):
    """(R, L) symbols -> (R, L-k+1) int32 keys; invalid (contains N/pad)
    keys return -1.  Also returns the valid mask."""
    R, L = reads.shape
    n = L - k + 1
    keys = torch.zeros((R, n), dtype=torch.int32, device=reads.device)
    bad = torch.zeros((R, n), dtype=torch.bool, device=reads.device)
    for j in range(k):
        sym = reads[:, j : j + n].to(torch.int32)
        bad = bad | (sym >= 4)
        keys = (keys << 2) | (sym & 3)
    return torch.where(bad, -1, keys), ~bad


def _in_read(lens, n: int, k: int):
    return (torch.arange(n, device=lens.device)[None, :] + k
            <= lens.to(torch.int64)[:, None])


def sample_kmers(bf: BloomFilter, reads, lens, *, k: int):
    """Pass 1: count every read k-mer into the sketch (ref: nvLighter
    sample_kmers.cu)."""
    keys, ok = _kmer_keys(reads, k)
    use = ok & _in_read(lens, keys.shape[1], k)
    return counting_insert(bf, keys, use)


def error_correct(bf: BloomFilter, reads, lens, *, k: int,
                  min_support: int = 2, min_count: int = 3):
    """Pass 2 (ref: nvLighter error_correct.cu): returns (corrected
    reads int8, n_corrections per read int32).  A k-mer is trusted when
    its count-min estimate reaches `min_count`.

    Only suspect bases can change, so the (position, alternative base)
    sweep runs over the suspects alone, compacted by one ``nonzero``
    (the reference sweeps every position and masks): the same gains,
    argmax and corrections at a fraction of the work."""
    R, L = reads.shape
    dev = reads.device
    n = L - k + 1
    keys, okk = _kmer_keys(reads, k)
    use = okk & _in_read(lens, n, k)
    trusted = (counting_query(bf, keys) >= min_count) & use

    # coverage of each base by trusted k-mers
    cov = torch.zeros((R, L), dtype=torch.int32, device=dev)
    t32 = trusted.to(torch.int32)
    for s in range(k):  # shift-add the trusted windows
        cov[:, s : s + n] += t32
    suspect = (cov == 0) & (torch.arange(L, device=dev)[None, :]
                            < lens.to(torch.int64)[:, None]) & (reads < 4)
    sr, sp = torch.nonzero(suspect, as_tuple=True)

    # evaluate every (suspect position, alt base): how many covering
    # k-mers become trusted if reads[r, p] -> b
    gain = torch.zeros((4, sr.shape[0]), dtype=torch.int32, device=dev)
    bases = torch.arange(4, dtype=torch.int32, device=dev)[:, None]
    for d in range(k):  # k-mer starting at p - d covers p at offset d
        shift = 2 * (k - 1 - d)
        st = sp - d
        sc = st.clamp(0, n - 1)
        base_keys = keys[sr, sc]
        valid_s = (st >= 0) & (st < n) & use[sr, sc] & (base_keys >= 0)
        cleared = base_keys & ~(3 << shift)
        cand = cleared[None] | (bases << shift)
        hit = (counting_query(bf, cand) >= min_count) & valid_s
        gain += hit.to(torch.int32)

    best_b = torch.argmax(gain, dim=0).to(torch.int8)
    do = gain.amax(dim=0) >= min_support
    corrected = reads.to(torch.int8).clone()
    corrected[sr, sp] = torch.where(do, best_b, corrected[sr, sp])
    ncorr = torch.zeros(R, dtype=torch.int32, device=dev)
    ncorr.index_add_(0, sr, do.to(torch.int32))
    return corrected, ncorr


class Corrector(NamedTuple):
    bf: BloomFilter
    k: int

    @staticmethod
    def build(reads_iter, lens_iter, k: int = 15, log2_slots: int = 24,
              device="cpu"):
        """Pass 1 over all batches (numpy or tensors), on ``device``."""
        bf = make_bloom(log2_slots, device=device)
        for reads, lens in zip(reads_iter, lens_iter):
            bf = sample_kmers(bf, torch.as_tensor(reads).to(device),
                              torch.as_tensor(np.asarray(lens, np.int32))
                              .to(device), k=k)
        return Corrector(bf=bf, k=k)

    def correct(self, reads, lens, min_support: int = 2,
                min_count: int = 3, rounds: int = 1):
        """`rounds` > 1 re-runs the vectorized sweep on the corrected
        output — the fixed-shape analog of Lighter's greedy loop
        continuing along the read: each round can fix one more error
        per k-window (a 2nd error inside the same window leaves no
        trusted covering k-mer for round 1 to gain from).  Returns
        numpy (corrected reads int8, corrections per read int32)."""
        dev = self.bf.slots.device
        out = torch.as_tensor(reads).to(dev)
        jl = torch.as_tensor(np.asarray(lens, np.int32)).to(dev)
        ncorr = np.zeros(out.shape[0], np.int32)
        for _ in range(max(rounds, 1)):
            out, nc = error_correct(
                self.bf, out, jl, k=self.k,
                min_support=min_support, min_count=min_count,
            )
            nc = nc.cpu().numpy()
            ncorr += nc
            if not nc.any():
                break
        return out.cpu().numpy(), ncorr
