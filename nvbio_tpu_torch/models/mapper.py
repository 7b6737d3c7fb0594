"""Seed-and-extend short-read mapper (nvBowtie-equivalent), in PyTorch.

Port of ``nvbio_tpu/models/mapper.py`` for the single-end path:

    seed -> FM backward search (+ k-mer LUT) -> rarity-first select ->
    compacted SSA locate -> compacted banded Gotoh extension (K3; K4
    for reads longer than LONG_THRESHOLD) -> top-2 + MAPQ -> escalation
    round -> winners-only directions DP (K2; K4 for long reads) +
    run-jump walk -> native CIGAR/MD builder (a Python fallback over
    ``alignment/cigar.py`` without g++) -> SAM

Every stage runs on the device of the index tensors (``"cuda"`` or
``"cpu"``, named by the caller).  The two DP stages go through the
kernel wrappers in ``ops/banded_dp.py``: the CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.  The stream runs
eagerly, one chunk after another.

Bit-identity with the reference rests on: stable argsort for the rarity
order, first-index argmax, the slot-rank-major compactions with the
reference's capacity arithmetic over the padded batch, float32
score-min, and dropped scatters sent to one dump slot that is sliced
off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..alignment.cigar import cigar_to_string, make_md_string
from ..alignment.types import NEG_INF, AlignmentType, gap_penalties
from ..alignment.walk import runjump_walk
from ..basic.alphabet import dna_to_char
from ..fmindex.backtrack import hamming_backtrack_1
from ..fmindex.index import FMIndex, SSA, backward_search, locate
from ..io.genome import concat_to_contig
from ..io.sam import (FLAG_REVERSE, FLAG_SECONDARY, FLAG_UNMAPPED,
                      SamRecord)
from ..native import ops_batch_native
from ..ops.banded_dp import (LONG_THRESHOLD, banded_directions,
                             banded_score, banded_score_packed,
                             pack_genome_words, window_slices)
from ..strings.seeds import (extract_seeds_per_read, extract_uniform_seeds,
                             num_uniform_seeds)
from .mapq import mapq_v2
from .params import MapperParams, eval_simple_func

PAD = 7
#: the rarity priority of an empty hit slot
_PRIO_INF = 1 << 30


def _revcomp_batch(reads, lens, quals, uniform_shift: int = -1):
    """Reverse-complement left-aligned padded reads (and reverse quals).

    ``uniform_shift >= 0``: every read has length L - uniform_shift, so
    the reverse is a flip and a left shift; otherwise a per-row gather."""
    R, L = reads.shape
    if uniform_shift >= 0:
        sh = uniform_shift
        g = reads.flip(1)
        rc = torch.where(g < 4, 3 - g, g).to(reads.dtype)
        q = quals.flip(1)
        if sh:
            rc = torch.nn.functional.pad(rc[:, sh:], (0, sh), value=PAD)
            q = torch.nn.functional.pad(q[:, sh:], (0, sh), value=0)
        return rc, q
    idx = lens.to(torch.int64)[:, None] - 1 - torch.arange(
        L, device=reads.device)[None, :]
    ok = idx >= 0
    g = torch.gather(reads, 1, idx.clamp(min=0))
    rc = torch.where(ok, torch.where(g < 4, 3 - g, g), PAD).to(reads.dtype)
    q = torch.gather(quals, 1, idx.clamp(min=0))
    q = torch.where(ok, q, 0).to(quals.dtype)
    return rc, q


def both_strands(reads, lens, quals, uniform_shift: int = -1):
    """Stack forward + reverse-complement rows: (2R, L) tensors."""
    rc_reads, rc_quals = _revcomp_batch(reads, lens, quals,
                                        uniform_shift=uniform_shift)
    return (torch.cat([reads, rc_reads]), torch.cat([quals, rc_quals]),
            torch.cat([lens, lens]))


def _score_min(lens, params: MapperParams):
    """Per-read minimum score: the Bowtie2 --score-min function of read
    length, in float32 then ceil, as the reference computes it."""
    x = lens.to(torch.float32)
    fn = params.score_min_fn
    if fn == "C":
        return torch.full_like(x, math.ceil(np.float32(params.score_min_a))
                               ).to(torch.int32)
    if fn == "L":
        g = x
    elif fn == "S":
        g = torch.sqrt(x)
    elif fn == "G":
        g = torch.log(x.clamp(min=1.0))
    else:
        raise ValueError(f"unknown score-min function {fn!r}")
    return torch.ceil(params.score_min_a + params.score_min_b * g).to(
        torch.int32)


def score_min_host(L: int, params: MapperParams) -> int:
    """Host-scalar twin of _score_min."""
    fn = params.score_min_fn
    if fn == "C":
        return math.ceil(params.score_min_a)
    g = {"L": float(L), "S": math.sqrt(L), "G": math.log(max(L, 1))}[fn]
    return math.ceil(params.score_min_a + params.score_min_b * g)


def _score_perfect(lens, params: MapperParams):
    return (lens * params.scheme.match).to(torch.int32)


def _compact_slots(ok, vals, capacity: int):
    """Slot-rank-major compaction of the valid entries of the (N, K)
    ``ok`` mask: every lane's rank-j slot before any lane's rank-j+1
    slot, the first ``capacity`` kept.  Returns (comp (capacity,) values,
    keep (K * N,) flat mask, cpos (K * N,) compacted positions) with the
    flat arrays in slot-rank-major order."""
    okT = ok.t().reshape(-1)
    cpos = torch.cumsum(okT.to(torch.int64), 0) - 1
    keep = okT & (cpos < capacity)
    # dropped entries all land in one dump slot, sliced off below
    tgt = torch.where(keep, cpos, capacity)
    comp = torch.zeros(capacity + 1, dtype=vals.dtype, device=vals.device)
    comp[tgt] = vals.t().reshape(-1)
    return comp[:capacity], keep, cpos


def extend_candidates(fm: FMIndex, gwords, all_reads, all_quals, lens2, cand,
                      *, params: MapperParams, genome=None):
    """Diagonal dedupe + banded Gotoh extension of located candidates:
    K3 over packed windows, or, for reads longer than LONG_THRESHOLD, K4
    over symbol windows of ``genome`` (the padded genome, Mapper.genome)
    as the reference routes them.  Returns dict of (R, 2C) tensors plus
    cand_overflow."""
    R2, L = all_reads.shape
    R = R2 // 2
    C = params.max_candidates
    W = params.band_w
    LT = L + 2 * W
    n = fm.n
    SENT = n + 2 * L + 1
    dev = all_reads.device
    cand = torch.sort(cand.clamp(max=SENT), dim=1).values
    first = torch.cat([torch.ones((R2, 1), dtype=torch.bool, device=dev),
                       cand[:, 1:] != cand[:, :-1]], dim=1)
    # budget signal: more unique diagonals than the C-slot list holds
    n_uniq = (first & (cand < SENT)).sum(dim=1)
    cand = torch.sort(torch.where(first, cand, SENT), dim=1).values[:, :C]
    cand_ok = cand < SENT

    # extension, cross-read compacted slot-rank-major into an
    # extend_frac-budgeted dense batch (reads that drop candidates
    # surface in cand_overflow -> escalation)
    win_start = cand.clamp(max=max(n - 1, 0))
    EXT_CAP = max(int(R2 * C * params.extend_frac) // 8 * 8, 1024)
    EXT_CAP = min(EXT_CAP, R2 * C)
    ridx = torch.arange(R2, device=dev)[:, None].expand(R2, C)
    ws_c, keep, cpos = _compact_slots(cand_ok, win_start, EXT_CAP)
    ridx_c, _, _ = _compact_slots(cand_ok, ridx, EXT_CAP)
    n_kept = keep.sum()
    lane_ok = torch.arange(EXT_CAP, device=dev) < n_kept
    pats = all_reads[ridx_c]
    pquals = all_quals[ridx_c]
    plens = torch.where(lane_ok, lens2[ridx_c], 0)  # pad lanes exit early
    tlens = (n - ws_c).clamp(0, LT)
    if L > LONG_THRESHOLD:
        if genome is None:
            raise ValueError(
                f"reads of {L} bp (> {LONG_THRESHOLD}) extend over symbol "
                "windows: pass the padded genome")
        res = banded_score(pats, plens, window_slices(genome, ws_c, LT),
                           tlens, pquals, scheme=params.scheme,
                           atype=params.atype, band_w=W)
    else:
        res = banded_score_packed(pats, plens, gwords, ws_c, tlens, pquals,
                                  scheme=params.scheme, atype=params.atype,
                                  band_w=W)
    # scatter back to the (C, R2) slot layout; dropped slots NEG_INF
    back = cpos.clamp(0, EXT_CAP - 1)
    scores = torch.where(keep, res["score"][back], NEG_INF).reshape(C, R2).t()
    t_end = torch.where(keep, res["t_end"][back], 0).reshape(C, R2).t()
    p_end = torch.where(keep, res["p_end"][back], 0).reshape(C, R2).t()
    okT = cand_ok.t().reshape(-1)
    ext_dropped = (okT & ~keep).reshape(C, R2).any(dim=0)

    def to_r2c(a):
        return a.reshape(2, R, C).permute(1, 0, 2).reshape(R, 2 * C)

    return {
        "score": to_r2c(scores),
        "win_start": to_r2c(win_start),
        "t_end": to_r2c(t_end),
        "p_end": to_r2c(p_end),
        "cand_overflow": ((n_uniq > C).reshape(2, R).any(dim=0)
                          | ext_dropped.reshape(2, R).any(dim=0)),
    }


def locate_compact(fm: FMIndex, ssa: SSA, rows, ok, *, k_sample: int,
                   capacity: int):
    """SSA-locate only the valid rows of an (N, K) budget matrix,
    compacted slot-rank-major into ``capacity`` lanes; on overflow the
    globally least-prioritised slots drop.  Returns (pos (N, K), ok_out
    (N, K), n_dropped scalar tensor)."""
    N, K = rows.shape
    comp_rows, keep, cpos = _compact_slots(ok, rows, capacity)
    n_dropped = ok.sum() - keep.sum()
    comp_pos = locate(fm, ssa, comp_rows, k_sample=k_sample)
    pos_flat = torch.where(keep, comp_pos[cpos.clamp(0, capacity - 1)], 0)
    return (pos_flat.reshape(K, N).t(), keep.reshape(K, N).t(), n_dropped)


def extract_seed_batch(all_reads, lens2, *, params: MapperParams):
    """Returns (seeds (2R, S, seed_len), offsets (2R, S), sval)."""
    R2, L = all_reads.shape
    if params.seed_slots > 0:
        return extract_seeds_per_read(
            all_reads, lens2, params.seed_len, params.seed_slots,
            params.seed_interval_fn, params.seed_interval_a,
            params.seed_interval_b)
    seeds, offsets, sval = extract_uniform_seeds(
        all_reads, lens2, params.seed_len, params.seed_interval)
    return seeds, offsets[None, :].expand(R2, -1), sval


def seed_and_search(fm: FMIndex, all_reads, lens2, *, params: MapperParams,
                    lut=None, pre_seeds=None):
    """Seed extraction + FM backward search.  ``pre_seeds``: (seeds,
    offsets, sval) from extract_seed_batch, made once for every shard of
    a sharded index.  Returns (lo, hi (2R, S), offsets (2R, S), sval,
    flat_seeds (2R * S, seed_len))."""
    R2, L = all_reads.shape
    seeds, offsets, sval = (pre_seeds if pre_seeds is not None
                            else extract_seed_batch(all_reads, lens2,
                                                    params=params))
    S = seeds.shape[1]
    flat_seeds = seeds.reshape(R2 * S, params.seed_len)
    lut_k = params.lut_k if lut is not None else 0
    lo, hi = backward_search(fm, flat_seeds, lut=lut, lut_k=lut_k)
    return lo.reshape(R2, S), hi.reshape(R2, S), offsets, sval, flat_seeds


def select_and_locate(fm: FMIndex, ssa: SSA, lo, hi, offsets, sval, L, *,
                      params: MapperParams):
    """Rarity-first hit selection + compacted SSA locate.  Returns (cand
    (2R, KLOC) window starts, >= SENT invalid; ovf (2R,); n_drop)."""
    R2, S = lo.shape
    CAP = params.max_hits_per_seed
    n = fm.n
    dev = lo.device
    sizes = torch.where(sval, hi - lo, 0)
    use = torch.where(sizes > params.max_range, 0,
                      sizes.clamp(max=CAP))
    ovf = (sval & (sizes > params.max_range)).any(dim=1)
    t = torch.arange(CAP, device=dev)
    rows = (lo[:, :, None] + t).reshape(R2, S * CAP)
    hit_ok = (t < use[:, :, None]).reshape(R2, S * CAP)
    prio = torch.where(hit_ok, sizes[:, :, None].expand(R2, S, CAP)
                       .reshape(R2, S * CAP), _PRIO_INF)
    KLOC = min(params.max_locate, S * CAP)
    order = torch.argsort(prio, dim=1, stable=True)[:, :KLOC]
    rows_sel = torch.gather(rows, 1, order)
    ok_sel = torch.gather(prio, 1, order) < _PRIO_INF
    offs_sel = torch.gather(offsets[:, :, None].expand(R2, S, CAP)
                            .reshape(R2, S * CAP), 1, order)
    capacity = max(int(R2 * KLOC * params.locate_frac) // 8 * 8, 512)
    pos, ok_loc, n_drop = locate_compact(
        fm, ssa, rows_sel.clamp(0, n), ok_sel, k_sample=params.sa_sample,
        capacity=capacity)
    ovf = ovf | (ok_sel & ~ok_loc).any(dim=1)
    ovf = ovf | (use.sum(dim=1) > KLOC)
    SENT = n + 2 * L + 1
    cand = torch.where(ok_loc, pos - offs_sel, SENT)
    return cand.clamp(min=0), ovf, n_drop


def mm_candidates(fm: FMIndex, ssa: SSA, flat_seeds, offsets, L, *,
                  params: MapperParams):
    """1-substitution seeding (-N 1): the SA range of every variant of
    every seed (``hamming_backtrack_1``), up to max_hits_per_mm rows
    each, located in one compacted pass of its own budget
    (mm_locate_frac).  Returns (cand (2R, S * seed_len * 4 * CAPV),
    ovf (2R,), n_drop) in the reference's column order."""
    R2, S = offsets.shape
    n = fm.n
    CAPV = params.max_hits_per_mm
    NV = params.seed_len * 4
    bt = hamming_backtrack_1(fm, flat_seeds)
    vlo = bt["lo"].reshape(R2, S, NV)
    vsz = torch.where(bt["valid"], bt["hi"] - bt["lo"], 0).reshape(R2, S, NV)
    use_v = torch.where(vsz > params.max_range, 0, vsz.clamp(max=CAPV))
    tv = torch.arange(CAPV, device=vlo.device)
    KV = S * NV * CAPV
    rows_v = (vlo[..., None] + tv).clamp(0, n).reshape(R2, KV)
    ok_v = (tv < use_v[..., None]).reshape(R2, KV)
    pos_v, ok_v2, n_drop = locate_compact(
        fm, ssa, rows_v, ok_v, k_sample=params.sa_sample,
        capacity=max(int(R2 * KV * params.mm_locate_frac) // 8 * 8, 512))
    ovf = (ok_v & ~ok_v2).any(dim=1)
    offs = offsets[:, :, None].expand(R2, S, NV * CAPV).reshape(R2, KV)
    cand = torch.where(ok_v2, pos_v - offs, n + 2 * L + 1)
    return cand.clamp(min=0), ovf, n_drop


def stage_reads(reads, lens, quals, *, params: MapperParams,
                uniform_shift: int = -1):
    """The index-independent front of candidate_stage (strands + seed
    extraction): the ``pre`` tuple that candidate_stage accepts, made
    once a batch for all the shards of a sharded index."""
    all_reads, all_quals, lens2 = both_strands(
        reads, lens, quals, uniform_shift=uniform_shift)
    return (all_reads, all_quals, lens2,
            *extract_seed_batch(all_reads, lens2, params=params))


def candidate_stage(fm, ssa, gwords, reads, lens, quals, *,
                    params: MapperParams, lut=None, uniform_shift: int = -1,
                    genome=None, pre=None):
    """Strands -> seeds -> search -> select -> locate -> extend: per-
    candidate (R, 2C) tensors (columns [0, C) forward, [C, 2C) reverse).
    With ``seed_mismatches >= 1`` (-N 1) every one-substitution variant
    of every seed joins the candidate pool (``mm_candidates``).  ``pre``:
    stage_reads' output for these reads, in place of its recomputation."""
    R, L = reads.shape
    if pre is None:
        pre = stage_reads(reads, lens, quals, params=params,
                          uniform_shift=uniform_shift)
    all_reads, all_quals, lens2 = pre[:3]
    lo, hi, offsets, sval, flat_seeds = seed_and_search(
        fm, all_reads, lens2, params=params, lut=lut, pre_seeds=pre[3:])
    cand, ovf, n_drop = select_and_locate(fm, ssa, lo, hi, offsets, sval, L,
                                          params=params)
    if params.seed_mismatches >= 1:
        cand_v, ovf_v, n_drop_v = mm_candidates(fm, ssa, flat_seeds, offsets,
                                                L, params=params)
        cand = torch.cat([cand, cand_v], dim=1)
        ovf = ovf | ovf_v
        n_drop = n_drop + n_drop_v
    out = extend_candidates(fm, gwords, all_reads, all_quals, lens2, cand,
                            params=params, genome=genome)
    out["locate_dropped"] = n_drop
    out["overflow"] = (ovf.reshape(2, R).any(dim=0)
                       | out.pop("cand_overflow"))
    return out


def top2(sc):
    """(bi, best, second) along dim 1 of ``sc``: the index of the first
    maximum (jnp.argmax's rule on ties), the maximum, and the maximum
    with that one entry excluded."""
    cols = torch.arange(sc.shape[1], device=sc.device)
    best = sc.max(dim=1).values
    bi = torch.where(sc == best[:, None], cols, sc.shape[1]).min(dim=1).values
    second = torch.where(cols[None, :] == bi[:, None], NEG_INF,
                         sc).max(dim=1).values
    return bi, best, second


def take_at(a, idx):
    """``a[r, idx[r]]`` for every row r."""
    return torch.gather(a, 1, idx[:, None])[:, 0]


def top2_finish(cands, lens, params: MapperParams):
    """Top-2 reduce across strands and candidates + MAPQ.  A candidate
    dict without the budget keys (the MEM and q-gram steps pass
    extend_candidates' output) reports no locate drop and no overflow,
    as the reference does."""
    C = params.max_candidates
    bi, best, second = top2(cands["score"])
    has_second = second > NEG_INF // 2
    smin = _score_min(lens, params)
    smax = _score_perfect(lens, params)
    aligned = (best >= smin) & (lens > 0)

    def take(a):
        return take_at(a, bi)

    mapq = torch.where(
        aligned,
        mapq_v2(best, second, has_second & (second >= smin), smin, smax), 0)
    return {
        "aligned": aligned,
        "score": best,
        "second": second,
        "has_second": has_second,
        "strand": (bi // C).to(torch.int32),
        "win_start": take(cands["win_start"]),
        "t_end": take(cands["t_end"]),
        "p_end": take(cands["p_end"]),
        "mapq": mapq.to(torch.int32),
        "locate_dropped": cands.get(
            "locate_dropped", torch.zeros((), dtype=torch.int64,
                                          device=lens.device)),
        "overflow": cands.get(
            "overflow", torch.zeros(lens.shape, dtype=torch.bool,
                                    device=lens.device)),
    }


def map_batch(fm: FMIndex, ssa: SSA, gwords, reads, lens, quals, *,
              params: MapperParams, lut=None, uniform_shift: int = -1,
              genome=None):
    """Forward mapping step: per-read best/second alignments + MAPQ.
    ``genome`` (the padded genome) is needed for reads longer than
    LONG_THRESHOLD.  Returns dict of (R,) tensors: aligned, score,
    second, has_second, strand, win_start, t_end, p_end, mapq (+
    locate_dropped, overflow)."""
    cands = candidate_stage(fm, ssa, gwords, reads, lens, quals,
                            params=params, lut=lut,
                            uniform_shift=uniform_shift, genome=genome)
    return top2_finish(cands, lens, params)


def map_all_batch(fm: FMIndex, ssa: SSA, gwords, reads, lens, quals, *,
                  params: MapperParams, k: int = 8, lut=None, genome=None):
    """All-mappings forward step (-a): the top-k candidates of each read
    by score (score-descending, ties to the lower column), each with
    score, strand, win_start, t_end, p_end and ``valid`` (score >=
    score-min).  "All" is bounded by the 2 * max_candidates slots, as in
    the reference.  Returns dict of (R, k) tensors."""
    C = params.max_candidates
    k = min(k, 2 * C)
    cands = candidate_stage(fm, ssa, gwords, reads, lens, quals,
                            params=params, lut=lut, genome=genome)
    sc = cands["score"]
    order = torch.argsort(-sc, dim=1, stable=True)[:, :k]

    def take(a):
        return torch.gather(a, 1, order)

    scores = take(sc)
    smin = _score_min(lens, params)
    return {
        "score": scores,
        "valid": (scores >= smin[:, None]) & (lens[:, None] > 0),
        "strand": (order // C).to(torch.int32),
        "win_start": take(cands["win_start"]),
        "t_end": take(cands["t_end"]),
        "p_end": take(cands["p_end"]),
    }


def _max_cigar_runs(L: int, params: MapperParams) -> int:
    """Worst-case CIGAR run count of any alignment that can pass
    score-min (each gap run costs at least open + extend)."""
    eo, ee, fo, fe = gap_penalties(params.scheme)
    budget = max(L * params.scheme.match - score_min_host(L, params), 0)
    gap_runs = budget // max(min(eo, fo) + min(ee, fe), 1)
    return int(min(2 * gap_runs + 4, 2 * L + 4))


def traceback_walk_windows(texts, tlens, reads, lens, quals, strand, *,
                           params: MapperParams, active=None):
    """Winners-only directions DP (K2; K4 beyond LONG_THRESHOLD) +
    run-jump walk over pre-gathered windows (R, L + 2 * band_w).
    Returns (dp result, walk dict)."""
    R, L = reads.shape
    W = params.band_w
    rc_reads, rc_quals = _revcomp_batch(reads, lens, quals)
    rev = strand[:, None] == 1
    pats = torch.where(rev, rc_reads, reads)
    pquals = torch.where(rev, rc_quals, quals)
    res, dirs = banded_directions(pats, lens, texts, tlens, pquals,
                                  scheme=params.scheme, atype=params.atype,
                                  band_w=W)
    STRIDE = 2 * W + 1
    i0 = res["p_end"].to(torch.int64)
    k0 = res["t_end"].to(torch.int64) - i0 + W
    fi, fk, run_ops, run_lens = runjump_walk(
        dirs.reshape(R, L * STRIDE), STRIDE, i0, k0, active=active,
        max_runs=_max_cigar_runs(L, params))
    return res, {"run_ops": run_ops, "run_lens": run_lens, "p_start": fi,
                 "t_start": fi + fk - W}


def traceback_walk_batch(genome, n: int, reads, lens, quals, win_start,
                         strand, *, params: MapperParams, active=None):
    """Winners-only DP + walk; ``genome`` carries a PAD tail so every
    window is one slice."""
    LT = reads.shape[1] + 2 * params.band_w
    texts = window_slices(genome, win_start, LT)
    tlens = (n - win_start.to(torch.int64)).clamp(0, LT)
    return traceback_walk_windows(texts, tlens, reads, lens, quals, strand,
                                  params=params, active=active)


def runs_to_packed(run_ops: np.ndarray, run_lens: np.ndarray) -> np.ndarray:
    """Expand CIGAR runs (end->start order) into the 2-bit packed op
    stream the native string builder consumes (host numpy)."""
    run_ops = np.asarray(run_ops)
    run_lens = np.asarray(run_lens).astype(np.int64)
    R = run_ops.shape[0]
    total = run_lens.sum(axis=1)
    MAX = int(total.max()) if total.size else 0
    MAX4 = max((MAX + 3) // 4 * 4, 4)
    codes = np.zeros((R, MAX4), np.uint8)
    flat = np.repeat(run_ops.ravel(), run_lens.ravel())
    rows = np.repeat(np.arange(R), total)
    offs = np.zeros(R, np.int64)
    np.cumsum(total[:-1], out=offs[1:])
    idx = np.arange(flat.size, dtype=np.int64) - np.repeat(offs, total)
    codes[rows, idx] = flat
    return (codes[:, 0::4] | (codes[:, 1::4] << 2)
            | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))


@dataclass
class MapResult:
    """One read's final alignment (host side)."""

    aligned: bool
    pos: int = 0  # 0-based concat-genome position of the alignment start
    strand: int = 0
    score: int = 0
    second: int | None = None
    mapq: int = 0
    cigar: str = "*"
    md: str = ""
    nm: int = 0
    ref_span: int = 0  # genome bases consumed (CIGAR M+D)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Mapper:
    """Host orchestration: index + genome + params -> SAM records, on the
    device of the index tensors."""

    #: re-map reads whose round-1 budgets overflowed (params.max_effort)
    ESCALATES = True

    def __init__(self, fm: FMIndex, ssa: SSA, genome_symbols: np.ndarray,
                 params: MapperParams = MapperParams(), ref_name: str = "ref",
                 contigs: dict | None = None, lut=None):
        self._init_host(fm.bwt_words.device, ssa.k, genome_symbols, params,
                        ref_name, contigs)
        self.fm = fm
        self.ssa = ssa
        self.lut = lut
        gp = self._genome_np
        self.genome = torch.from_numpy(gp).to(self.device)
        # 2-bit packed genome for the extension kernel (K3)
        self.gwords = pack_genome_words(gp[: self.n], device=self.device)

    def _init_host(self, device, ssa_k, genome_symbols, params, ref_name,
                   contigs):
        """The host state every mapper shares: params, contigs, the padded
        host genome and the counters (the device state is the caller's)."""
        self.device = device
        # adopt the index's SSA sampling rate (a smaller one corrupts
        # locate positions, a larger one wastes LF steps)
        if ssa_k and params.sa_sample != ssa_k:
            params = replace(params, sa_sample=ssa_k)
        self.params = params
        self.ref_name = ref_name
        self.n = int(genome_symbols.shape[0])
        if contigs is None:
            contigs = {"names": [ref_name], "starts": np.zeros(1, np.int64),
                       "lens": np.array([self.n], np.int64)}
        self.contigs = contigs
        lt_pad = params.max_read_len + 2 * params.band_w + 8
        gp = np.full(self.n + lt_pad, PAD, dtype=np.int8)
        gp[: self.n] = genome_symbols
        # host copy (int64-indexed) for the native CIGAR/MD builder
        self._genome_np = gp
        self.locate_dropped = 0  # locate-budget slots dropped, round 1
        self.escalated = 0  # re-maps performed by escalation rounds
        self.overflowed = 0  # reads whose round-1 budgets overflowed

    @staticmethod
    def _len_bucket(seqs, lens, quals):
        """Trim the pad axis to the batch's max length rounded up to 32."""
        if len(lens) == 0:
            return seqs, quals
        lb = max(32, (int(lens.max()) + 31) // 32 * 32)
        lb = min(lb, seqs.shape[1])
        return seqs[:, :lb], quals[:, :lb]

    def _pad_chunk(self, seqs, lens, quals):
        """Pad a partial chunk to batch_size rows (the compaction
        capacities scale with the padded batch)."""
        B = self.params.batch_size
        R = seqs.shape[0]
        if R < B:
            pad = B - R
            seqs = np.concatenate(
                [seqs, np.full((pad, seqs.shape[1]), PAD, seqs.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
            quals = np.concatenate(
                [quals, np.zeros((pad, quals.shape[1]), quals.dtype)])
        return seqs, lens, quals

    def _chunk_params(self, max_len: int,
                      min_len: int | None = None) -> MapperParams:
        """Per-chunk params for the Bowtie2 ``-i`` interval function:
        uniform-length chunks get one interval; mixed-length chunks take
        the per-read path (seed_slots > 0) sized for the densest length."""
        p = self.params
        if p.seed_interval_fn is None:
            return p

        def iv_of(length: int) -> int:
            return max(1, int(eval_simple_func(
                p.seed_interval_fn, p.seed_interval_a, p.seed_interval_b,
                max(int(length), 1)) + 0.5))

        max_len = max(int(max_len), 1)
        if min_len is not None and int(min_len) != max_len:
            slots = max(
                (num_uniform_seeds(length, p.seed_len, iv_of(length))
                 for length in range(max(int(min_len), p.seed_len),
                                     max_len + 1)), default=1)
            return replace(p, seed_slots=max(slots, 1))
        iv = iv_of(max_len)
        return p if iv == p.seed_interval else replace(p, seed_interval=iv)

    def _upload(self, seqs, lens, quals):
        """A padded host chunk -> (reads int8, lens int64, quals uint8)
        tensors on the mapper's device."""
        dev = self.device
        return (torch.from_numpy(np.ascontiguousarray(seqs, np.int8)).to(dev),
                torch.from_numpy(lens.astype(np.int64)).to(dev),
                torch.from_numpy(np.ascontiguousarray(quals, np.uint8)).to(dev))

    def _dispatch_chunk(self, seqs, lens, quals, params=None):
        """Map one chunk: forward step + winners-only traceback."""
        R = seqs.shape[0]
        params = params or self._chunk_params(
            lens.max() if len(lens) else seqs.shape[1],
            lens.min() if len(lens) else None)
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        jr, jl, jq = self._upload(seqs, lens, quals)
        # uniform-length batches take the flip-and-shift revcomp path
        ushift = (seqs.shape[1] - int(lens.max())
                  if len(lens) and lens.min() == lens.max() else -1)
        fwd = self._forward(jr, jl, jq, uniform_shift=ushift, params=params)
        res, walk = traceback_walk_batch(
            self.genome, self.n, jr, jl, jq, fwd["win_start"],
            fwd["strand"], params=params, active=fwd["aligned"])
        return (seqs, lens, quals, fwd, res, walk, R)

    def _forward(self, jr, jl, jq, uniform_shift: int = -1, params=None):
        """The forward mapping step of one uploaded chunk; the MEM and
        q-gram mappers swap the seeding here."""
        return map_batch(self.fm, self.ssa, self.gwords, jr, jl, jq,
                         params=params or self.params, lut=self.lut,
                         uniform_shift=uniform_shift, genome=self.genome)

    def _escalated_params(self, round_i: int = 2, base=None):
        """Round-``round_i`` budgets (>= 2), each round a superset of the
        previous one's search effort."""
        p = base or self.params
        f = 8 ** (round_i - 1)
        k = 2 ** (round_i - 1)
        return replace(
            p, max_range=p.max_range * f, locate_frac=1.0,
            mm_locate_frac=1.0, max_locate=min(p.max_locate * k, 128),
            max_candidates=min(p.max_candidates * k, 64), extend_frac=1.0,
            max_effort=1)

    def _finish_handle(self, handle):
        seqs, lens, quals, fwd, res, walk, R = handle
        return self._finish(seqs, lens, quals, fwd, res, walk)[:R], fwd

    def _collect_chunk(self, handle):
        seqs, lens, quals, fwd, res, walk, R = handle
        self.locate_dropped += int(fwd["locate_dropped"])
        self.overflowed += int(_host(fwd["overflow"])[:R].sum())
        results = self._finish(seqs, lens, quals, fwd, res, walk)[:R]
        if self.ESCALATES and self.params.max_effort > 1:
            results = self._escalate_chunk(seqs, lens, quals, fwd, results, R)
        return results

    def _escalate_chunk(self, seqs, lens, quals, fwd, results, R):
        """Effort-escalation rounds: reads whose budgets overflowed
        re-map with escalated budgets, up to ``max_effort`` rounds."""
        base = self._chunk_params(
            lens.max() if len(lens) else seqs.shape[1],
            lens.min() if len(lens) else None)
        overflow = _host(fwd["overflow"])[:R].copy()
        for rnd in range(2, base.max_effort + 1):
            idx = np.flatnonzero(overflow)
            if idx.size == 0:
                break
            p2 = self._escalated_params(rnd, base)
            h2 = self._dispatch_chunk(seqs[:R][idx], lens[:R][idx],
                                      np.asarray(quals[:R])[idx], params=p2)
            fin2, fwd2 = self._finish_handle(h2)
            for j, r2 in zip(idx, fin2):
                if r2.aligned or not results[j].aligned:
                    results[j] = r2
            self.escalated += int(idx.size)
            overflow[:] = False
            overflow[idx] = _host(fwd2["overflow"])[: idx.size]
        return results

    def map_reads(self, seqs: np.ndarray, lens: np.ndarray,
                  quals: np.ndarray) -> list[MapResult]:
        """Map one padded batch; returns per-read MapResult."""
        B = self.params.batch_size
        seqs, quals = self._len_bucket(seqs, lens, quals)
        out: list[MapResult] = []
        for s0 in range(0, seqs.shape[0], B):
            out.extend(self._collect_chunk(self._dispatch_chunk(
                seqs[s0 : s0 + B], lens[s0 : s0 + B], quals[s0 : s0 + B])))
        return out

    def map_reads_all(self, seqs: np.ndarray, lens: np.ndarray,
                      quals: np.ndarray, max_alns: int = 8):
        """All-mappings mode (-a): per read, up to ``max_alns`` distinct
        alignments at or above score-min, score-descending, each traced
        back to a full MapResult.  Returns one list per read."""
        R = seqs.shape[0]
        B = self.params.batch_size
        seqs, quals = self._len_bucket(seqs, lens, quals)
        out: list[list[MapResult]] = []
        for s0 in range(0, R, B):
            out.extend(self._map_chunk_all(
                seqs[s0 : s0 + B], lens[s0 : s0 + B], quals[s0 : s0 + B],
                max_alns))
        return out

    def _map_chunk_all(self, seqs, lens, quals, k):
        """One chunk of -a: map_all_batch, then the (B * K) slots traced
        back as one pseudo-batch with ``active`` = valid."""
        R = seqs.shape[0]
        B = self.params.batch_size
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        jr, jl, jq = self._upload(seqs, lens, quals)
        fwd = map_all_batch(self.fm, self.ssa, self.gwords, jr, jl, jq,
                            params=self.params, k=k, lut=self.lut,
                            genome=self.genome)
        K = fwd["score"].shape[1]
        res, walk = traceback_walk_batch(
            self.genome, self.n, jr.repeat_interleave(K, dim=0),
            jl.repeat_interleave(K), jq.repeat_interleave(K, dim=0),
            fwd["win_start"].reshape(-1), fwd["strand"].reshape(-1),
            params=self.params, active=fwd["valid"].reshape(-1))
        flat_fwd = {
            "aligned": _host(fwd["valid"]).reshape(-1),
            "strand": _host(fwd["strand"]).reshape(-1),
            "win_start": _host(fwd["win_start"]).reshape(-1),
            "score": _host(fwd["score"]).reshape(-1),
            "second": np.zeros(B * K, np.int32),
            "has_second": np.zeros(B * K, bool),
            "mapq": np.zeros(B * K, np.int32),
        }
        results = self._finish(
            np.repeat(seqs, K, axis=0), np.repeat(lens, K),
            np.repeat(quals, K, axis=0), flat_fwd, res, walk)
        return self._group_all(results, min(R, B), K)

    @staticmethod
    def _group_all(results, R, K):
        """Group the flat (R * K) -a results by read, dropping repeats of
        one (pos, strand) that overlapping windows give."""
        grouped = []
        for r in range(R):
            seen, uniq = set(), []
            for a in results[r * K : (r + 1) * K]:
                if a.aligned and (a.pos, a.strand) not in seen:
                    seen.add((a.pos, a.strand))
                    uniq.append(a)
            grouped.append(uniq)
        return grouped

    def map_stream(self, packed_iter):
        """Map an iterator of (names, seqs, lens, quals) batches, one
        chunk after another; yields (names, seqs, lens, quals, results)
        per input batch (seqs/quals trimmed to the length bucket)."""
        for names, seqs, lens, quals in packed_iter:
            seqs, quals = self._len_bucket(seqs, lens, quals)
            yield names, seqs, lens, quals, self.map_reads(seqs, lens, quals)

    @staticmethod
    def _corrected_pats(seqs, lens, strand):
        """Strand-corrected patterns (vectorised reverse-complement)."""
        R, L = seqs.shape
        idx = lens[:, None].astype(np.int64) - 1 - np.arange(L)
        ok = idx >= 0
        g = np.take_along_axis(seqs.astype(np.uint8),
                               np.maximum(idx, 0).astype(np.int64), axis=1)
        rc = np.where(ok, np.where(g < 4, 3 - g, g), PAD).astype(np.uint8)
        return np.where(strand[:, None] == 1, rc, seqs.astype(np.uint8))

    def _finish(self, seqs, lens, quals, fwd, res, walk):
        """CIGAR/MD/NM from the walked op streams: the native C++ builder,
        or, where it cannot be built, the Python fallback over cigar.py."""
        aligned = _host(fwd["aligned"])
        strand = _host(fwd["strand"])
        win_start = _host(fwd["win_start"]).astype(np.int64)
        score = _host(fwd["score"])
        second = _host(fwd["second"])
        has_second = _host(fwd["has_second"])
        mapq = _host(fwd["mapq"])
        run_lens = np.where(aligned[:, None], _host(walk["run_lens"]), 0)
        ops = runs_to_packed(_host(walk["run_ops"]), run_lens)
        pats = self._corrected_pats(seqs, lens, strand)
        p_start, t_start = _host(walk["p_start"]), _host(walk["t_start"])
        is_global = self.params.atype == AlignmentType.GLOBAL
        native = ops_batch_native(
            ops, p_start, t_start, aligned, pats, lens, self._genome_np,
            win_start, is_global)
        if native is None:
            native = self._finish_python(ops, p_start, t_start, aligned,
                                         pats, lens, win_start, is_global)
        cigars, mds, nms, poss, spans = native
        return [
            MapResult(
                aligned=True, ref_span=int(spans[r]), pos=int(poss[r]),
                strand=int(strand[r]), score=int(score[r]),
                second=int(second[r]) if has_second[r] else None,
                mapq=int(mapq[r]), cigar=cigars[r], md=mds[r],
                nm=int(nms[r]),
            ) if aligned[r] else MapResult(aligned=False)
            for r in range(seqs.shape[0])
        ]

    def _finish_python(self, ops, p_start, t_start, aligned, pats, lens,
                       win_start, is_global):
        """The builder's outputs (cigars, mds, nms, poss, spans) in Python,
        as the reference falls back without g++: decode the 2-bit walk
        codes, prepend GLOBAL's leading D run, run-length encode, then
        make_md_string and cigar_to_string."""
        W = self.params.band_w
        codes = np.stack([(ops >> s) & 3 for s in (0, 2, 4, 6)],
                         axis=-1).reshape(ops.shape[0], -1)
        n = ops.shape[0]
        cigars, mds = [""] * n, [""] * n
        nms, poss, spans = (np.zeros(n, np.int64) for _ in range(3))
        for r in np.flatnonzero(aligned):
            fops = ["\0MDI"[c] for c in codes[r][codes[r] != 0][::-1]]
            ts, ps = int(t_start[r]), int(p_start[r])
            if is_global and ts > 0:
                fops = ["D"] * ts + fops
                ts = 0
            cigar_ops = []
            for op in fops:
                if cigar_ops and cigar_ops[-1][0] == op:
                    cigar_ops[-1][1] += 1
                else:
                    cigar_ops.append([op, 1])
            cigar_ops = [(o, ln) for o, ln in cigar_ops]
            window = self._genome_np[win_start[r]:
                                     win_start[r] + lens[r] + 2 * W]
            mds[r], nms[r] = make_md_string(pats[r], window, ps, ts,
                                            cigar_ops)
            cigars[r] = cigar_to_string(cigar_ops, ps, int(lens[r]))
            poss[r] = win_start[r] + ts
            spans[r] = sum(ln for op, ln in cigar_ops if op in "MD")
        return cigars, mds, nms, poss, spans

    def locate_contig(self, mr: MapResult):
        """Concat position -> (contig name, local pos); None if the
        alignment crosses a contig boundary (reported unmapped)."""
        return concat_to_contig(mr.pos, max(mr.ref_span, 1),
                                self.contigs["starts"], self.contigs["lens"],
                                self.contigs["names"])

    def to_sam_records(self, names, seqs, lens, quals,
                       results: list[MapResult]):
        """MapResults -> SamRecords (SEQ is the forward-strand read for
        FLAG 16 records, per SAM convention)."""
        recs = []
        for i, mr in enumerate(results):
            pat = seqs[i, : lens[i]].astype(np.uint8)
            q = quals[i, : lens[i]].astype(np.uint8)
            if mr.aligned and mr.strand == 1:
                pat = np.where(pat < 4, 3 - pat, pat)[::-1].astype(np.uint8)
                q = q[::-1]
            seq_str = dna_to_char(pat).tobytes().decode()
            qual_str = (q + 33).tobytes().decode()
            loc = self.locate_contig(mr) if mr.aligned else None
            if loc is None:
                recs.append(SamRecord(names[i], FLAG_UNMAPPED, "*", 0, 0,
                                      "*", seq_str, qual_str))
                continue
            rname, lpos = loc
            tags = [("AS", "i", mr.score), ("NM", "i", mr.nm),
                    ("MD", "Z", mr.md)]
            if mr.second is not None:
                tags.insert(1, ("XS", "i", mr.second))
            recs.append(SamRecord(
                names[i], FLAG_REVERSE if mr.strand else 0, rname, lpos + 1,
                mr.mapq, mr.cigar, seq_str, qual_str, tags=tags))
        return recs

    def to_sam_records_all(self, names, seqs, lens, quals,
                           all_results: list[list[MapResult]]):
        """-a records: per read its best alignment as the primary record
        (unmapped if none), then the others with FLAG_SECONDARY."""
        recs = []
        for i, alns in enumerate(all_results):
            one = (names[i : i + 1], seqs[i : i + 1], lens[i : i + 1],
                   quals[i : i + 1])
            recs.extend(self.to_sam_records(
                *one, [alns[0] if alns else MapResult(aligned=False)]))
            for a in alns[1:]:
                (sec,) = self.to_sam_records(*one, [a])
                sec.flag |= FLAG_SECONDARY
                recs.append(sec)
        return recs
