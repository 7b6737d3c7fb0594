"""Paired-end mapping (Bowtie2-compatible semantics), in PyTorch.

Port of ``nvbio_tpu/models/paired.py``.  Decision ladder per pair, as
the reference:

  1. best concordant candidate pair (each mate >= its score-min), from
     one ``candidate_stage`` over both mates and a (2C x 2C) score matrix;
  2. rescue: anchor = the best single-end mate; the other mate is
     searched over the anchor's insert window with overlapping band-63
     semi-global chunks (``_chunk_plan``), or, in LOCAL mode, one band
     over the whole window, through ``ops.banded_dp.banded_score``: the
     plain K1 on the CPU, K4 on CUDA (``route()`` sends bands past 64
     cells there), with K1's output contract;
  3. discordant: both mates uniquely aligned but not concordant;
  4. mixed: each mate reported as single-end (or unmapped).

Bit-identity with the reference rests on the mapper's rules (first-index
argmax, compactions with the reference's capacities and a dump slot for
dropped scatters) plus: read-major chunk lanes with the smallest global
t_end among the best chunks, and window gathers that clamp past the
padded genome's end as JAX's gathers do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..alignment.types import NEG_INF, AlignmentType, gap_penalties
from ..basic.alphabet import dna_to_char
from ..io import sam as S
from ..ops.banded_dp import banded_score
from .mapper import (PAD, Mapper, MapResult, _host, _revcomp_batch,
                     _score_min, _score_perfect, candidate_stage,
                     score_min_host, take_at, top2, traceback_walk_batch)
from .mapq import mapq_v2
from .params import MapperParams


def _owned(ws, span):
    """Window origins inside a shard's ownership interval [lo, hi)."""
    lo, hi = span
    return (ws >= lo) & (ws < hi)


def _se_reduce(c, lens, params: MapperParams, span=None):
    """Top-2 single-end reduction over a candidate dict (R, 2C).  With
    ``span`` = (lo, hi) (a shard of a sharded index) only the candidates
    whose window origin the shard owns count."""
    C = params.max_candidates
    sc = c["score"]
    if span is not None:
        sc = torch.where(_owned(c["win_start"], span), sc, NEG_INF)
    bi, best, second = top2(sc)
    return {
        "best": best,
        "second": second,
        "bi": bi,
        "sc": sc,
        "aligned": (best >= _score_min(lens, params)) & (lens > 0),
        "strand": (bi // C).to(torch.int32),
        "win_start": take_at(c["win_start"], bi),
    }


def _chunk_plan(L: int, LT: int, params: MapperParams):
    """Static plan for the chunked window rescue: cover the insert window
    with overlapping band-63 sub-windows, origins every sigma = 63 - T,
    where T bounds the gap extension of any alignment that can pass
    score-min, so every above-threshold alignment stays in some chunk's
    band.  Returns (w_c, CW, origins), or None when the margin is too
    thin (LOCAL, or a very permissive score-min)."""
    if params.atype != AlignmentType.SEMI_GLOBAL:
        return None
    w_c = 63
    budget = L * params.scheme.match - score_min_host(L, params)
    eo, ee, fo, fe = gap_penalties(params.scheme)
    margin = w_c - int((budget - min(eo, fo)) // min(ee, fe))
    if margin < 12:
        return None
    s_max = (LT - L) // 2
    n_chunks = max(1, math.ceil((s_max + 1) / margin))
    return w_c, L + w_c + 8, tuple(c * margin for c in range(n_chunks))


def _chunked_window_score(pats, lens, texts, tlens, quals,
                          params: MapperParams, plan):
    """Window-wide best semi-global alignment via overlapping narrow-band
    chunks (see _chunk_plan), one ``banded_score`` call over R * C lanes
    in read-major order.  Ties between chunks go to the smallest global
    t_end."""
    R = pats.shape[0]
    LT = texts.shape[1]
    w_c, CW, origins = plan
    C = len(origins)
    bs = torch.tensor(origins, dtype=torch.int64, device=pats.device)
    texts_p = torch.nn.functional.pad(
        texts, (0, max(0, origins[-1] + CW - LT)), value=PAD)
    tc = torch.stack([texts_p[:, b:b + CW] for b in origins],
                     dim=1).reshape(R * C, CW)
    tlc = (tlens.to(torch.int64)[:, None] - bs[None, :]).clamp(0, CW)

    def rep(a):
        return a.repeat_interleave(C, dim=0)

    res = banded_score(rep(pats), rep(lens), tc, tlc.reshape(R * C),
                       rep(quals), scheme=params.scheme, atype=params.atype,
                       band_w=w_c)
    sc = res["score"].reshape(R, C)
    te = res["t_end"].reshape(R, C).to(torch.int64) + bs[None, :]
    best = sc.max(dim=1).values
    t_end = torch.where(sc == best[:, None], te, 1 << 30).min(dim=1).values
    t_end = torch.where(best > NEG_INF // 2, t_end, 0).to(torch.int32)
    return {"score": best, "t_end": t_end, "p_end": lens}


def _pair_cases(params: MapperParams, p1, e1, st1, p2, e2, st2):
    """Concordance predicate over broadcastable position/strand tensors
    (bowtie2 --fr/--rf/--ff, --dovetail, --no-contain, --no-overlap):
    (ok_a, ok_b), case a = mate 1 upstream, case b = mate 2 upstream.
    Positions are window starts, so the insert bounds and the dovetail
    test carry band_w slack.  Shared by the candidate matrix and the
    rescued-pair check."""
    slack = params.band_w
    ins_a = e2 - p1
    ins_b = e1 - p2
    if params.pe_orient == "fr":
        str_a = (st1 == 0) & (st2 == 1)
        str_b = (st1 == 1) & (st2 == 0)
    elif params.pe_orient == "rf":
        str_a = (st1 == 1) & (st2 == 0)
        str_b = (st1 == 0) & (st2 == 1)
    elif params.pe_orient == "ff":
        str_a = (st1 == 0) & (st2 == 0)
        str_b = (st1 == 1) & (st2 == 1)
    else:
        raise ValueError(f"unknown pe_orient {params.pe_orient!r}")

    def geom_ok(up_s, up_e, dn_s, dn_e):
        ok = torch.ones(torch.broadcast_shapes(up_s.shape, dn_s.shape),
                        dtype=torch.bool, device=up_s.device)
        if not params.pe_dovetail:
            ok = ok & ~(dn_s < up_s - slack)
        if params.pe_no_contain:
            ok = ok & ~(((dn_s >= up_s) & (dn_e <= up_e))
                        | ((up_s >= dn_s) & (up_e <= dn_e)))
        if params.pe_no_overlap:
            ok = ok & ~((dn_s < up_e) & (up_s < dn_e))
        return ok

    ok_a = (str_a & (ins_a >= params.minins - slack)
            & (ins_a <= params.maxins + slack) & geom_ok(p1, e1, p2, e2))
    ok_b = (str_b & (ins_b >= params.minins - slack)
            & (ins_b <= params.maxins + slack) & geom_ok(p2, e2, p1, e1))
    return ok_a, ok_b


def _rescue(genome, n: int, anchor_ws, anchor_strand, anchor_len,
            mate_reads, mate_lens, mate_quals, params: MapperParams,
            mate_is_2: bool = True):
    """Opposite-mate window search: semi-global DP of the mate, in the
    orientation params.pe_orient implies, over the anchor's insert
    window.  Returns (score, win_start, strand, t_end, p_end) of the
    rescued mate, win_start tightened to the alignment found."""
    R, L = mate_reads.shape
    W = params.band_w
    rescue_w = params.maxins + 2 * W
    LT = L + 2 * rescue_w
    rc_reads, rc_quals = _revcomp_batch(mate_reads, mate_lens, mate_quals)
    if params.pe_orient == "ff":
        m_strand = anchor_strand.to(torch.int32)
    else:
        m_strand = torch.where(anchor_strand == 0, 1, 0).to(torch.int32)
    rev = m_strand[:, None] == 1
    pats = torch.where(rev, rc_reads, mate_reads)
    pquals = torch.where(rev, rc_quals, mate_quals)
    # is the missing mate downstream of the anchor?
    if params.pe_orient == "fr":
        downstream = anchor_strand == 0
    elif params.pe_orient == "rf":
        downstream = anchor_strand == 1
    elif params.pe_orient == "ff":
        downstream = (anchor_strand == 0) == bool(mate_is_2)
    else:
        raise ValueError(f"unknown pe_orient {params.pe_orient!r}")
    anchor_ws = anchor_ws.to(torch.int64)
    ws_up = anchor_ws + anchor_len.to(torch.int64) - params.maxins - 2 * W
    win_start = torch.where(downstream, anchor_ws, ws_up).clamp(
        0, max(n - 1, 0))
    # a gather past the padded genome's end reads its last (PAD) symbol
    gidx = win_start[:, None] + torch.arange(LT, device=genome.device)
    texts = genome[gidx.clamp(max=genome.shape[0] - 1)]
    tlens = (n - win_start).clamp(0, LT)
    plan = _chunk_plan(L, LT, params)
    if plan is not None:
        res = _chunked_window_score(pats, mate_lens, texts, tlens, pquals,
                                    params, plan)
    else:
        # LOCAL, or a score-min too permissive for the chunk plan: one
        # band over the whole window, as the reference (through its twin;
        # the twin and K1/K4 agree on every lane the rescue consumes:
        # those at or above score-min)
        res = banded_score(pats, mate_lens, texts, tlens, pquals,
                           scheme=params.scheme, atype=params.atype,
                           band_w=rescue_w)
    ws_tight = (win_start + res["t_end"] - res["p_end"]).clamp(
        0, max(n - 1, 0))
    return {"score": res["score"], "win_start": ws_tight,
            "strand": m_strand, "t_end": res["t_end"], "p_end": res["p_end"]}


def pe_map_batch(fm, ssa, gwords, genome, r1, l1, q1, r2, l2, q2, *,
                 params: MapperParams, lut=None, span=None):
    """Paired forward step over one padded chunk of R pairs.  Returns
    per-mate dicts (aligned, strand, win_start, score, mapq, second,
    has_second, se_* details, resc) and pair info (proper, discordant,
    has_conc, pair_score, pair_second, locate_dropped, rescue_dropped).

    ``span`` = (lo, hi): the index is one shard of a sharded index, whose
    ownership interval in local window origins is [lo, hi).  A concordant
    or rescued pair belongs to the shard that owns its leftmost mate's
    origin, an SE candidate to the shard that owns its own; the shard
    overlap covers a whole pair, so boundary pairs are found whole in the
    left shard."""
    R = r1.shape[0]
    C = params.max_candidates
    n = fm.n
    dev = r1.device
    # one candidate stage over both mates (2R reads)
    cc = candidate_stage(fm, ssa, gwords, torch.cat([r1, r2]),
                         torch.cat([l1, l2]), torch.cat([q1, q2]),
                         params=params, lut=lut, genome=genome)
    c1 = {k: v[:R] if v.ndim else v for k, v in cc.items()}
    c2 = {k: v[R:] if v.ndim else v for k, v in cc.items()}
    c2["locate_dropped"] = torch.zeros((), dtype=torch.int64, device=dev)
    smin1 = _score_min(l1, params)
    smin2 = _score_min(l2, params)

    # --- concordant pairing over the candidate matrix ---
    cols = torch.arange(2 * C, device=dev)
    st1 = (cols // C)[None, :, None]
    st2 = (cols // C)[None, None, :]
    p1 = c1["win_start"][:, :, None]
    p2 = c2["win_start"][:, None, :]
    s1ok = (c1["score"] >= smin1[:, None])[:, :, None]
    s2ok = (c2["score"] >= smin2[:, None])[:, None, :]
    e1 = p1 + l1[:, None, None]
    e2 = p2 + l2[:, None, None]
    conc_a, conc_b = _pair_cases(params, p1, e1, st1, p2, e2, st2)
    if span is not None:
        conc_a = conc_a & _owned(p1, span)
        conc_b = conc_b & _owned(p2, span)
    conc = (conc_a | conc_b) & s1ok & s2ok
    pair_sc = torch.where(
        conc, c1["score"][:, :, None] + c2["score"][:, None, :],
        NEG_INF).reshape(R, 4 * C * C)
    pbi, pair_best, pair_second = top2(pair_sc)
    has_conc = pair_best > NEG_INF // 2
    i1 = pbi // (2 * C)
    i2 = pbi % (2 * C)

    se1 = _se_reduce(c1, l1, params, span=span)
    se2 = _se_reduce(c2, l2, params, span=span)
    # rescue anchors on the unmasked reduction: a reverse-strand anchor
    # just right of a shard boundary has its window clamped in its own
    # shard, while the previous shard, whose overlap holds it whole, can
    # rescue the pair; ownership then goes by the rescued pair's leftmost
    # coordinate
    an1, an2 = ((se1, se2) if span is None
                else (_se_reduce(c1, l1, params), _se_reduce(c2, l2, params)))

    # --- mate rescue (anchor = the better-aligned single mate), on a
    # compacted capacity of lanes; overflow pairs skip it (counted) ---
    if params.enable_rescue:
        needs = (~has_conc) & (an1["aligned"] | an2["aligned"])
        capR = max(min(R // 4, 4096), 64)
        cpos = torch.cumsum(needs.to(torch.int64), 0) - 1
        slot_ok = needs & (cpos < capR)
        rescue_dropped = needs.sum() - slot_ok.sum()
        # empty slots hold R; dropped pairs land in the dump slot capR
        lane_idx = torch.full((capR + 1,), R, dtype=torch.int64, device=dev)
        lane_idx[torch.where(slot_ok, cpos, capR)] = torch.arange(R,
                                                                  device=dev)
        lane_idx = lane_idx[:capR]
        gi = lane_idx.clamp(max=R - 1)  # garbage rows for empty slots

        def g(a):
            return a[gi]

        r2c = _rescue(genome, n, g(an1["win_start"]), g(an1["strand"]),
                      g(l1), g(r2), g(l2), g(q2), params, mate_is_2=True)
        r1c = _rescue(genome, n, g(an2["win_start"]), g(an2["strand"]),
                      g(l2), g(r1), g(l1), g(q1), params, mate_is_2=False)

        def scat(vals, fill):
            out = torch.full((R + 1,), fill, dtype=vals.dtype, device=dev)
            out[lane_idx] = vals  # empty slots land in the dump slot R
            return out[:R]

        res2 = {"score": scat(r2c["score"], NEG_INF),
                "win_start": scat(r2c["win_start"], 0),
                "strand": scat(r2c["strand"], 0)}
        res1 = {"score": scat(r1c["score"], NEG_INF),
                "win_start": scat(r1c["win_start"], 0),
                "strand": scat(r1c["strand"], 0)}
        # a rescued pair must satisfy the concordance predicate that
        # admits candidate pairs
        va, vb = _pair_cases(
            params, an1["win_start"], an1["win_start"] + l1, an1["strand"],
            res2["win_start"], res2["win_start"] + l2, res2["strand"])
        wa, wb = _pair_cases(
            params, res1["win_start"], res1["win_start"] + l1,
            res1["strand"], an2["win_start"], an2["win_start"] + l2,
            an2["strand"])
        resc2_ok = an1["aligned"] & (res2["score"] >= smin2) & (va | vb)
        resc1_ok = an2["aligned"] & (res1["score"] >= smin1) & (wa | wb)
        rsc_a = torch.where(resc2_ok, an1["best"] + res2["score"], NEG_INF)
        rsc_b = torch.where(resc1_ok, an2["best"] + res1["score"], NEG_INF)
        if span is not None:
            left_a = torch.where(an1["strand"] == 0, an1["win_start"],
                                 res2["win_start"])
            left_b = torch.where(an2["strand"] == 0, an2["win_start"],
                                 res1["win_start"])
            rsc_a = torch.where(_owned(left_a, span), rsc_a, NEG_INF)
            rsc_b = torch.where(_owned(left_b, span), rsc_b, NEG_INF)
        use_a = rsc_a >= rsc_b
        has_rescue = (rsc_a > NEG_INF // 2) | (rsc_b > NEG_INF // 2)
        rescue_pair = torch.where(use_a, rsc_a, rsc_b)
    else:
        has_rescue = torch.zeros(R, dtype=torch.bool, device=dev)
        use_a = torch.ones(R, dtype=torch.bool, device=dev)
        rescue_pair = torch.full((R,), NEG_INF, dtype=torch.int32,
                                 device=dev)
        rescue_dropped = torch.zeros((), dtype=torch.int64, device=dev)
        res1 = res2 = None

    proper = has_conc | ((~has_conc) & has_rescue)
    discordant = (~proper) & se1["aligned"] & se2["aligned"]

    def pick(which):
        """Final per-mate fields by the decision ladder."""
        se, an, cand, i, smin, res = (
            (se1, an1, c1, i1, smin1, res1) if which == 1
            else (se2, an2, c2, i2, smin2, res2))
        # layer 1: concordant candidate
        strand = torch.where(has_conc, (i // C).to(torch.int32),
                             se["strand"])
        ws = torch.where(has_conc, take_at(cand["win_start"], i),
                         se["win_start"])
        score = torch.where(has_conc, take_at(cand["score"], i), se["best"])
        aligned = has_conc | se["aligned"]
        resc_here = torch.zeros_like(has_conc)
        # layer 2: rescue overrides when no concordant pair
        if params.enable_rescue:
            # mate 1 is rescued when use_a is False (anchor = mate 2)
            resc_here = (~has_conc) & has_rescue & (
                (~use_a) if which == 1 else use_a)
            strand = torch.where(resc_here, res["strand"], strand)
            ws = torch.where(resc_here, res["win_start"], ws)
            score = torch.where(resc_here, res["score"], score)
            aligned = aligned | resc_here
            # this mate anchored the rescue: report the (unmasked)
            # anchor alignment
            anchor_here = (~has_conc) & has_rescue & (
                use_a if which == 1 else (~use_a))
            strand = torch.where(anchor_here, an["strand"], strand)
            ws = torch.where(anchor_here, an["win_start"], ws)
            score = torch.where(anchor_here, an["best"], score)
            aligned = aligned | anchor_here
        # XS = best alignment other than the reported one; a rescued
        # mate's alignment is not in the candidate list, so nothing is
        # excluded for it
        idx = torch.where(has_conc, i, se["bi"])
        scols = torch.arange(se["sc"].shape[1], device=dev)
        sc_excl = torch.where(scols[None, :] == idx[:, None], NEG_INF,
                              se["sc"])
        second = torch.where(resc_here, se["sc"].max(dim=1).values,
                             sc_excl.max(dim=1).values)
        return aligned, strand, ws, score, second, resc_here

    a1, st1f, ws1, sc1, xs1, resc1 = pick(1)
    a2, st2f, ws2, sc2, xs2, resc2 = pick(2)

    # --- MAPQ: pair-level for proper pairs, SE otherwise ---
    sperf = _score_perfect(l1, params) + _score_perfect(l2, params)
    sminp = smin1 + smin2
    pair_best_eff = torch.where(has_conc, pair_best, rescue_pair)
    pair_second_eff = torch.where(has_conc, pair_second, NEG_INF)
    mq_pair = mapq_v2(pair_best_eff, pair_second_eff,
                      pair_second_eff > NEG_INF // 2, sminp, sperf)
    mq1_se = mapq_v2(se1["best"], se1["second"], se1["second"] >= smin1,
                     smin1, _score_perfect(l1, params))
    mq2_se = mapq_v2(se2["best"], se2["second"], se2["second"] >= smin2,
                     smin2, _score_perfect(l2, params))
    mq1 = torch.where(proper, mq_pair, mq1_se)
    mq2 = torch.where(proper, mq_pair, mq2_se)

    def mate_out(a, stf, ws, sc, mq, xs, se, lens, resc):
        return {
            "aligned": a & (lens > 0), "strand": stf, "win_start": ws,
            "score": sc, "mapq": torch.where(a, mq, 0), "second": xs,
            "has_second": xs > NEG_INF // 2,
            "se_best": se["best"], "se_second": se["second"],
            "se_strand": se["strand"], "se_ws": se["win_start"],
            "se_aligned": se["aligned"],
            # placed by window rescue (its alignment is no candidate)
            "resc": resc,
        }

    return (
        mate_out(a1, st1f, ws1, sc1, mq1, xs1, se1, l1, resc1),
        mate_out(a2, st2f, ws2, sc2, mq2, xs2, se2, l2, resc2),
        {"proper": proper, "discordant": discordant & ~proper,
         "has_conc": has_conc, "pair_score": pair_best_eff,
         "pair_second": pair_second_eff,
         "locate_dropped": c1["locate_dropped"] + c2["locate_dropped"],
         "rescue_dropped": rescue_dropped},
    )


def apply_pair_policy(res1, res2, info, l1, l2, params: MapperParams):
    """Bowtie2's pair-reporting policy over finished MapResults:
    ``discordant`` only when both mates align uniquely (no second
    alignment at or above score-min); --no-discordant demotes such pairs
    to mixed; --no-mixed reports both mates of any non-proper,
    non-discordant pair unmapped.  Mutates and returns its arguments."""
    for i, pi in enumerate(info):
        if pi["proper"]:
            pi["discordant"] = False
            continue

        def unique(r, ln):
            if not r.aligned:
                return False
            return r.second is None or r.second < score_min_host(
                int(ln), params)

        disc = (pi["discordant"] and unique(res1[i], l1[i])
                and unique(res2[i], l2[i]))
        pi["discordant"] = disc and not params.no_discordant
        if not pi["discordant"] and params.no_mixed:
            res1[i] = MapResult(aligned=False)
            res2[i] = MapResult(aligned=False)
    return res1, res2, info


class PairedMapper(Mapper):
    """Paired-end orchestration: the paired forward step, per-mate
    traceback and SAM records with pair flags, on the device of the index
    tensors, one chunk after another."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rescued = 0  # pairs with a mate placed by window rescue
        self.rescue_dropped = 0  # pairs past the rescue capacity

    def map_pairs(self, seqs1, lens1, quals1, seqs2, lens2, quals2):
        """Returns (results1, results2, pair_info list of dicts)."""
        R = seqs1.shape[0]
        B = self.params.batch_size
        both_lens = np.concatenate([lens1, lens2])
        seqs1, quals1 = self._len_bucket(seqs1, both_lens, quals1)
        seqs2, quals2 = self._len_bucket(seqs2, both_lens, quals2)
        out1, out2, info = [], [], []
        for s0 in range(0, R, B):
            sl = slice(s0, s0 + B)
            r1, r2, pi = self._collect_pair_chunk(self._dispatch_pair_chunk(
                seqs1[sl], lens1[sl], quals1[sl], seqs2[sl], lens2[sl],
                quals2[sl]))
            out1.extend(r1)
            out2.extend(r2)
            info.extend(pi)
        return out1, out2, info

    def _stage_pair_batch(self, s1, l1, q1, s2, l2, q2):
        """Pad both mates to batch_size rows; the padded host arrays and
        their device tensors."""
        B = self.params.batch_size

        def padto(a, fill):
            if a.shape[0] >= B:
                return a
            pad = np.full((B - a.shape[0],) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, pad])

        host = ((padto(s1, PAD), padto(l1, 0), padto(q1, 0)),
                (padto(s2, PAD), padto(l2, 0), padto(q2, 0)))
        return host, tuple(self._upload(*mate) for mate in host)

    def _dispatch_pair_chunk(self, s1, l1, q1, s2, l2, q2):
        """Paired forward step + per-mate winners-only traceback."""
        R = s1.shape[0]
        # one -i interval serves the pair: the longer mate's max length,
        # the shorter mate's min length
        params = self._chunk_params(
            max(l1.max() if len(l1) else 0, l2.max() if len(l2) else 0, 1),
            min(l1.min() if len(l1) else 1, l2.min() if len(l2) else 1))
        host, tensors = self._stage_pair_batch(s1, l1, q1, s2, l2, q2)
        m1, m2, pair = pe_map_batch(
            self.fm, self.ssa, self.gwords, self.genome, *tensors[0],
            *tensors[1], params=params, lut=self.lut)
        walks = []
        for mate, (jr, jl, jq) in zip((m1, m2), tensors):
            res, walk = traceback_walk_batch(
                self.genome, self.n, jr, jl, jq, mate["win_start"],
                mate["strand"], params=params, active=mate["aligned"])
            walks.append((mate, res, walk))
        return host, walks, pair, R

    def _collect_pair_chunk(self, handle):
        host, walks, pair, R = handle
        self.locate_dropped += int(pair["locate_dropped"])
        self.rescue_dropped += int(pair["rescue_dropped"])
        resc = _host(walks[0][0]["resc"] | walks[1][0]["resc"])[:R]
        self.rescued += int(resc.sum())
        res1, res2 = [], []
        for (mate, res, walk), (sp, lp, qp), out in zip(walks, host,
                                                        (res1, res2)):
            out.extend(self._finish(sp, lp, qp, dict(mate), res, walk))
        proper = _host(pair["proper"])
        discordant = _host(pair["discordant"])
        info = [{"proper": bool(proper[i]), "discordant": bool(discordant[i])}
                for i in range(R)]
        return apply_pair_policy(res1[:R], res2[:R], info, host[0][1],
                                 host[1][1], self.params)

    def map_pairs_stream(self, packed_iter):
        """Map an iterator of (names, s1, l1, q1, s2, l2, q2) batches (at
        most batch_size pairs each), one after another; yields (names,
        s1, l1, q1, s2, l2, q2, res1, res2, info) with the reads trimmed
        to the pair's length bucket."""
        for names, s1, l1, q1, s2, l2, q2 in packed_iter:
            bl = np.concatenate([l1, l2])
            s1, q1 = self._len_bucket(s1, bl, q1)
            s2, q2 = self._len_bucket(s2, bl, q2)
            r1, r2, info = self._collect_pair_chunk(
                self._dispatch_pair_chunk(s1, l1, q1, s2, l2, q2))
            yield names, s1, l1, q1, s2, l2, q2, r1, r2, info

    def to_sam_records_pe(self, names, s1, l1, q1, s2, l2, q2, res1, res2,
                          info):
        """SAM records for both mates with pair flags, RNEXT/PNEXT/TLEN."""
        recs = []
        for i in range(len(names)):
            recs.append(self._pe_record(names[i], s1[i], l1[i], q1[i],
                                        res1[i], res2[i], info[i],
                                        first=True))
            recs.append(self._pe_record(names[i], s2[i], l2[i], q2[i],
                                        res2[i], res1[i], info[i],
                                        first=False))
        return recs

    def _pe_record(self, name, seq, ln, qual, mine, other, pi, first):
        pat = seq[:ln].astype(np.uint8)
        q = qual[:ln].astype(np.uint8)
        if mine.aligned and mine.strand == 1:
            pat = np.where(pat < 4, 3 - pat, pat)[::-1].astype(np.uint8)
            q = q[::-1]
        seq_str = dna_to_char(pat).tobytes().decode()
        qual_str = (q + 33).tobytes().decode()
        flag = S.FLAG_PAIRED | (S.FLAG_READ1 if first else S.FLAG_READ2)
        if not mine.aligned:
            flag |= S.FLAG_UNMAPPED
        elif mine.strand:
            flag |= S.FLAG_REVERSE
        if not other.aligned:
            flag |= S.FLAG_MATE_UNMAPPED
        elif other.strand:
            flag |= S.FLAG_MATE_REVERSE
        if pi["proper"] and mine.aligned and other.aligned:
            flag |= S.FLAG_PROPER_PAIR
        loc = self.locate_contig(mine) if mine.aligned else None
        if loc is None:
            return S.SamRecord(name, flag, "*", 0, 0, "*", seq_str, qual_str)
        rname, lpos = loc
        tlen = 0
        rnext, pnext = "*", 0
        oloc = self.locate_contig(other) if other.aligned else None
        if oloc is not None:
            ornm, opos = oloc
            rnext = "=" if ornm == rname else ornm
            pnext = opos + 1
            if rnext == "=":
                # the approximate fragment: from the left start to this
                # mate's length past the right start; the leftmost mate
                # (mate 1 on a tie) gets the positive sign
                left = min(lpos, opos)
                right = max(lpos + ln, opos + ln)
                tlen = right - left
                if lpos > opos or (lpos == opos and not first):
                    tlen = -tlen
        tags = [("AS", "i", mine.score), ("NM", "i", mine.nm),
                ("MD", "Z", mine.md)]
        if mine.second is not None:
            tags.insert(1, ("XS", "i", mine.second))
        return S.SamRecord(name, flag, rname, lpos + 1, mine.mapq, mine.cigar,
                           seq_str, qual_str, rnext=rnext, pnext=pnext,
                           tlen=tlen, tags=tags)
