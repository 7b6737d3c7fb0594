"""Synthetic genome + read simulation (wgsim-style).

The environment ships no genome data (and the reference mount is
empty), so tests and benchmarks use seeded synthetic references and
mutated reads with known ground-truth positions — this doubles as a
mapping-accuracy oracle, which the reference validates only indirectly
via nvbio-aln-diff comparisons (SURVEY.md §5.1).

A copy of ``nvbio_tpu/utils/simulate.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import numpy as np

from ..basic.alphabet import reverse_complement


def random_genome(n: int, seed: int = 0) -> np.ndarray:
    """Uniform random DNA of length n (uint8 symbols 0..3)."""
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def simulate_reads(
    genome: np.ndarray,
    n_reads: int,
    read_len: int = 100,
    error_rate: float = 0.01,
    indel_rate: float = 0.001,
    seed: int = 1,
):
    """Sample reads with substitution/indel errors from both strands.

    Returns dict with seqs (R, L) int8, quals (R, L) uint8,
    true_pos (R,) genome start of the sampled fragment,
    true_strand (R,) 0=fwd 1=rc.
    """
    rng = np.random.default_rng(seed)
    n = len(genome)
    frag = read_len + 8  # slack so indel-carrying reads still fill L
    starts = rng.integers(0, n - frag, n_reads)
    strands = rng.integers(0, 2, n_reads)
    seqs = np.zeros((n_reads, read_len), dtype=np.int8)
    quals = rng.integers(25, 41, (n_reads, read_len)).astype(np.uint8)
    for r in range(n_reads):
        template = genome[starts[r] : starts[r] + frag].copy()
        # apply errors on the template coordinates
        out = []
        i = 0
        while i < len(template) and len(out) < read_len:
            u = rng.random()
            if u < indel_rate:  # deletion from read (skip template base)
                i += 1
                continue
            if u < 2 * indel_rate:  # insertion into read
                out.append(rng.integers(0, 4))
                continue
            b = int(template[i])
            if rng.random() < error_rate:
                b = (b + 1 + rng.integers(0, 3)) % 4
            out.append(b)
            i += 1
        while len(out) < read_len:  # pad from genome tail if needed
            out.append(int(rng.integers(0, 4)))
        read = np.array(out[:read_len], dtype=np.uint8)
        if strands[r]:
            read = reverse_complement(read)
        seqs[r] = read
    return {
        "seqs": seqs,
        "quals": quals,
        "true_pos": starts.astype(np.int64),
        "true_strand": strands.astype(np.int8),
    }


def simulate_pairs(
    genome: np.ndarray,
    n_pairs: int,
    read_len: int = 100,
    insert_mean: int = 300,
    insert_sd: int = 30,
    error_rate: float = 0.01,
    seed: int = 2,
):
    """FR paired-end reads: mate1 = fragment 5' (forward), mate2 =
    fragment 3' (reverse-complement).  Returns per-mate seq/qual plus
    ground-truth fragment starts."""
    rng = np.random.default_rng(seed)
    n = len(genome)
    inserts = np.clip(
        rng.normal(insert_mean, insert_sd, n_pairs).astype(int),
        read_len, None,
    )
    starts = rng.integers(0, n - inserts.max() - 1, n_pairs)
    s1 = np.zeros((n_pairs, read_len), dtype=np.int8)
    s2 = np.zeros((n_pairs, read_len), dtype=np.int8)
    q1 = rng.integers(25, 41, (n_pairs, read_len)).astype(np.uint8)
    q2 = rng.integers(25, 41, (n_pairs, read_len)).astype(np.uint8)
    for r in range(n_pairs):
        frag = genome[starts[r] : starts[r] + inserts[r]]
        m1 = frag[:read_len].copy()
        m2 = reverse_complement(frag[-read_len:].copy())
        for m in (m1, m2):
            errs = rng.random(read_len) < error_rate
            m[errs] = (m[errs] + 1 + rng.integers(0, 3, errs.sum())) % 4
        s1[r], s2[r] = m1, m2
    return {
        "seqs1": s1, "quals1": q1, "seqs2": s2, "quals2": q2,
        "true_pos": starts.astype(np.int64),
        "insert": inserts.astype(np.int64),
    }

def _mutate_rows(rows: np.ndarray, rate, rng) -> np.ndarray:
    """Substitute a `rate` fraction of symbols per row (vectorized);
    rate may be scalar or per-row."""
    rows = rows.copy()
    rate = np.broadcast_to(np.asarray(rate, np.float64), (rows.shape[0],))
    hit = rng.random(rows.shape) < rate[:, None]
    delta = rng.integers(1, 4, rows.shape).astype(rows.dtype)
    rows[hit] = (rows[hit] + delta[hit]) % 4
    return rows


def repeat_structured_genome(
    n: int,
    seed: int = 0,
    alu_frac: float = 0.05,
    alu_len: int = 300,
    n_segdups: int = 6,
    segdup_len: int = 100_000,
    n_tandems: int = 200,
):
    """Synthetic genome with hg-like repeat structure (the environment
    ships no real genome and has no network — SURVEY.md §0 — so the
    repeat-stress campaign runs on planted structure instead: ALU-like
    high-copy interspersed elements with 5-15% per-copy divergence,
    segmental duplications at 1-3% divergence, and tandem arrays).

    Returns (genome uint8, info dict with the planted coordinates:
    alu_pos, segdup (src, dst, len) triples, tandem (pos, unit, count)
    triples) so accuracy campaigns can score per region class.
    """
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n, dtype=np.uint8)

    # ALU-like interspersed element
    alu = rng.integers(0, 4, alu_len, dtype=np.uint8)
    n_alu = int(n * alu_frac / alu_len)
    alu_pos = np.sort(rng.integers(0, n - alu_len, n_alu).astype(np.int64))
    div = rng.uniform(0.05, 0.15, n_alu)
    copies = _mutate_rows(np.broadcast_to(alu, (n_alu, alu_len)), div, rng)
    # strand-flip half the copies
    flip = rng.random(n_alu) < 0.5
    copies[flip] = np.where(copies[flip] < 4, 3 - copies[flip],
                            copies[flip])[:, ::-1]
    idx = alu_pos[:, None] + np.arange(alu_len)
    g[idx.reshape(-1)] = copies.reshape(-1)

    # segmental duplications (later plants overwrite earlier ALUs —
    # realistic nesting; coordinates record plant order)
    segdups = []
    for _ in range(n_segdups):
        L = int(segdup_len * rng.uniform(0.5, 1.5))
        src = int(rng.integers(0, n - L))
        dst = int(rng.integers(0, n - L))
        if abs(dst - src) < L:
            continue
        g[dst:dst + L] = _mutate_rows(
            g[src:src + L][None, :], rng.uniform(0.01, 0.03), rng)[0]
        segdups.append((src, dst, L))

    # tandem arrays
    tandems = []
    for _ in range(n_tandems):
        unit = int(rng.integers(20, 500))
        count = int(rng.integers(5, 50))
        L = unit * count
        if L >= n // 2:
            continue
        pos = int(rng.integers(0, n - L))
        u = rng.integers(0, 4, unit, dtype=np.uint8)
        arr = _mutate_rows(
            np.broadcast_to(u, (count, unit)), 0.01, rng)
        g[pos:pos + L] = arr.reshape(-1)
        tandems.append((pos, unit, count))

    return g, {
        "alu_pos": alu_pos, "alu_len": alu_len,
        "segdups": segdups, "tandems": tandems,
    }
