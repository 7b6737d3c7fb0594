"""Multi-contig genome preparation (nvBWT front half).

Ref parity: nvBWT/nvBWT.cpp — concatenate FASTA sequences, substitute
ambiguous bases with seeded-random ACGT (recording the ambiguity runs,
the reference's .amb), keep the name/offset table (.ann).

A copy of ``nvbio_tpu/io/genome.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import numpy as np


def prepare_genome(records, n_sub_seed: int = 7):
    """records: [(name, symbols 0..4)] from read_fasta.

    Returns dict: symbols (concat, uint8 0..3), names, starts, lens,
    amb (positions of substituted Ns as (start, len) runs).
    """
    names = [n for n, _ in records]
    lens = np.array([len(s) for _, s in records], dtype=np.int64)
    starts = np.zeros(len(records), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    concat = np.concatenate([s for _, s in records]).astype(np.uint8)
    amb_mask = concat >= 4
    rng = np.random.default_rng(n_sub_seed)
    concat[amb_mask] = rng.integers(0, 4, int(amb_mask.sum()))
    # run-length encode the ambiguity mask
    amb = []
    if amb_mask.any():
        d = np.diff(amb_mask.astype(np.int8))
        run_starts = np.nonzero(d == 1)[0] + 1
        run_ends = np.nonzero(d == -1)[0] + 1
        if amb_mask[0]:
            run_starts = np.concatenate([[0], run_starts])
        if amb_mask[-1]:
            run_ends = np.concatenate([run_ends, [len(amb_mask)]])
        amb = list(zip(run_starts.tolist(), (run_ends - run_starts).tolist()))
    return {
        "symbols": concat,
        "names": names,
        "starts": starts,
        "lens": lens,
        "amb": amb,
    }


def concat_to_contig(pos: int, span: int, starts, lens, names):
    """Map a concatenated-genome interval to (contig, local_pos);
    returns None if it crosses a contig boundary (such alignments are
    reported unmapped, as crossing alignments are artifacts of
    concatenation)."""
    i = int(np.searchsorted(starts, pos, side="right") - 1)
    local = pos - int(starts[i])
    if local + span > int(lens[i]):
        return None
    return names[i], local
