"""Mapping against a sharded FM-index (``fmindex/sharded.py``), in PyTorch.

Port of ``nvbio_tpu/models/sharded_mapper.py``.  The genome is split into
S shards, each with its own int32 index over [start, start + span +
overlap).  Per batch, strands and seeds are made once (``stage_reads``)
and the candidate stage runs against every shard with that shard's
genome slice and packed words, all positions shard-local.  An
**ownership rule** replaces a cross-shard dedupe: a candidate belongs to
the shard whose span holds its window origin, so an alignment crossing
a boundary counts once, in the left shard, whose overlap holds it whole.
A cross-shard top-2 picks best and second over the shard-major columns
(ties to the lowest (shard, strand, slot)); one traceback runs over each
lane's window in its winning shard.  Positions become global (start +
local, int64) only on the host.

Per shard the device holds its FM index, SSA, LUT, genome slice plus
its pad and packed words; there is no whole-genome device tensor.
"""

from __future__ import annotations

import functools
import numpy as np
import torch

from ..alignment.types import NEG_INF
from ..ops.banded_dp import pack_genome_words, window_slices
from .mapper import (Mapper, _host, _score_min,
                     _score_perfect, candidate_stage, stage_reads, take_at,
                     top2, traceback_walk_windows)
from .mapq import mapq_v2
from .paired import PairedMapper, apply_pair_policy, pe_map_batch
from .params import MapperParams


def _sharded_walk(states, ws, shard, reads, lens, quals, strand, *,
                  params: MapperParams, active=None):
    """Winner-shard traceback in one walk on the reads' device: each
    lane's window text comes from its winning shard's slice (S window
    gathers, each on its shard's device, and selects), then one
    winners-only DP (K2; K4 past LONG_THRESHOLD) and walk."""
    LT = reads.shape[1] + 2 * params.band_w
    texts = tlens = None
    for s, st in enumerate(states):
        wsc = ws.to(st["g"].device).clamp(0, st["length"] - 1)
        t_s = window_slices(st["g"], wsc, LT).to(reads.device)
        tl_s = (st["length"] - wsc).clamp(0, LT).to(reads.device)
        if texts is None:
            texts, tlens = t_s, tl_s
        else:
            m = shard == s
            texts = torch.where(m[:, None], t_s, texts)
            tlens = torch.where(m, tl_s, tlens)
    _, walk = traceback_walk_windows(texts, tlens, reads, lens, quals, strand,
                                     params=params, active=active)
    return walk


def _shard_cands(st, reads, lens, quals, *, params: MapperParams, pre):
    """One shard's candidate stage, ownership-masked: alignments starting
    in the overlap tail belong to the next shard, and window origins
    clamped to a non-first shard's left edge (local 0) are clipped
    duplicates of alignments the previous shard sees whole."""
    c = candidate_stage(st["fm"], st["ssa"], st["gw"], reads, lens, quals,
                        params=params, lut=st["lut"], genome=st["g"], pre=pre)
    lo, hi = st["own"]
    ws = c["win_start"]
    c["score"] = torch.where((ws >= lo) & (ws < hi), c["score"], NEG_INF)
    return c


def _shard_all(c, *, params: MapperParams, k: int = 8):
    """One shard's top-k candidates for -a (from _shard_cands' output)."""
    C = params.max_candidates
    order = torch.argsort(-c["score"], dim=1, stable=True)[:, :min(k, 2 * C)]
    return {"score": torch.gather(c["score"], 1, order),
            "strand": (order // C).to(torch.int32),
            "win_start": torch.gather(c["win_start"], 1, order)}


def _sharded_all_merge(per_shard, lens, params: MapperParams, k: int = 8):
    """Per-shard top-k lists -> a global score-descending top-k (ties to
    the lower shard-major column) with shard ids."""
    def cat(key):
        return torch.cat([p[key] for p in per_shard], dim=1)

    sc = cat("score")
    kk = per_shard[0]["score"].shape[1]
    shard_id = torch.arange(len(per_shard), dtype=torch.int32,
                            device=sc.device).repeat_interleave(kk)
    order = torch.argsort(-sc, dim=1, stable=True)[:, :k]

    def take(a):
        return torch.gather(a, 1, order)

    scores = take(sc)
    smin = _score_min(lens, params)
    return {
        "score": scores,
        "valid": (scores >= smin[:, None]) & (lens[:, None] > 0),
        "strand": take(cat("strand")),
        "win_start": take(cat("win_start")),  # shard-local
        "shard": take(shard_id[None, :].expand(sc.shape[0], -1)),
    }


def _sharded_top2(cands, lens, params: MapperParams):
    """Cross-shard top-2 over per-shard (R, 2C) candidate dicts; the
    locate drops summed, a read's budget overflow OR-ed over shards."""
    def cat(key):
        return torch.cat([c[key] for c in cands], dim=1)

    out = _top2_concat(cat("score"), cat("win_start"), cat("t_end"),
                       cat("p_end"), lens, params)
    out["locate_dropped"] = sum(c["locate_dropped"] for c in cands)
    out["overflow"] = functools.reduce(torch.logical_or,
                                       [c["overflow"] for c in cands])
    return out


def _top2_concat(sc, ws, te, pe, lens, params: MapperParams):
    """Cross-shard top-2 reduce over shard-major concatenated candidate
    columns (R, S * 2C): the first maximum wins, so ties resolve to the
    lowest (shard, strand, slot) column.  Standalone so that a
    shard-per-card layout can reduce the same columns the same way."""
    C = params.max_candidates
    bi, best, second = top2(sc)
    has_second = second > NEG_INF // 2
    smin = _score_min(lens, params)
    smax = _score_perfect(lens, params)
    aligned = (best >= smin) & (lens > 0)
    mapq = torch.where(
        aligned,
        mapq_v2(best, second, has_second & (second >= smin), smin, smax), 0)
    return {
        "aligned": aligned,
        "score": best,
        "second": second,
        "has_second": has_second,
        "strand": ((bi // C) % 2).to(torch.int32),
        "shard": (bi // (2 * C)).to(torch.int32),
        "win_start": take_at(ws, bi),  # shard-local
        "t_end": take_at(te, bi),
        "p_end": take_at(pe, bi),
        "mapq": mapq.to(torch.int32),
    }


def _sharded_pe_merge(shard_outs, l1, l2, rel, params: MapperParams):
    """Cross-shard reduction of per-shard pe_map_batch outputs: stacks
    them (S, R) for _pe_merge_stacked; the locate and rescue drops
    summed over shards."""
    def stack(i, key):
        return torch.stack([o[i][key] for o in shard_outs])

    st1 = {k: stack(0, k) for k in shard_outs[0][0]}
    st2 = {k: stack(1, k) for k in shard_outs[0][1]}
    stp = {k: stack(2, k)
           for k in ("has_conc", "pair_score", "pair_second", "proper")}
    m1, m2, pair = _pe_merge_stacked(st1, st2, stp, l1, l2, rel, params)
    for key in ("locate_dropped", "rescue_dropped"):
        pair[key] = sum(o[2][key] for o in shard_outs)
    return m1, m2, pair


def _pe_merge_stacked(st1, st2, stp, l1, l2, rel, params: MapperParams):
    """The single-index decision ladder over stacked (S, R) per-shard
    outputs: concordant pairs beat rescued pairs globally; pair MAPQ
    takes the global concordant second (the winner shard's second
    against the other shards' bests); the SE fields merge over the
    ownership-masked per-shard SE bests.  Pairs never split across
    shards (the overlap covers a pair), so per-shard pair scores
    partition the global pair set.

    ``rel`` (S, S) = starts[w] - starts[s] (INT32_MIN where the offset
    passes int32: such shards share no position) moves the reported
    mate's shard-w origin into shard s's frame, so that the XS merge
    leaves out the reported alignment itself where a non-winner shard
    owns it (a pair straddling a boundary)."""
    has_conc, p_sc = stp["has_conc"], stp["pair_score"]
    S = has_conc.shape[0]
    conc_sc = torch.where(has_conc, p_sc, NEG_INF)
    resc_sc = torch.where(stp["proper"] & ~has_conc, p_sc, NEG_INF)
    any_conc = has_conc.any(dim=0)
    # the first maximum over shards (jnp.argmax's tie rule, as top2)
    w = torch.where(any_conc, top2(conc_sc.t())[0], top2(resc_sc.t())[0])
    proper = any_conc | (resc_sc.max(dim=0).values > NEG_INF // 2)

    def takeS(a):
        return torch.gather(a, 0, w[None, :])[0]

    pair_score = takeS(p_sc)
    sid = torch.arange(S, device=w.device)[:, None]
    conc_others = torch.where(sid == w[None, :], NEG_INF, conc_sc)
    pair_second = torch.where(
        any_conc, torch.maximum(takeS(stp["pair_second"]),
                                conc_others.max(dim=0).values), NEG_INF)
    sperf_p = _score_perfect(l1, params) + _score_perfect(l2, params)
    smin_p = _score_min(l1, params) + _score_min(l2, params)
    mq_pair = mapq_v2(pair_score, pair_second, pair_second > NEG_INF // 2,
                      smin_p, sperf_p)

    def merge_mate(st, lens):
        se_best = st["se_best"]
        wg = top2(se_best.t())[0]

        def tG(a):
            return torch.gather(a, 0, wg[None, :])[0]

        g_best = tG(se_best)
        others_se = torch.where(sid == wg[None, :], NEG_INF, se_best)
        sec_se = torch.maximum(tG(st["se_second"]),
                               others_se.max(dim=0).values)
        # XS on the proper path: the winner shard's own second already
        # leaves out its reported alignment; the other shards add their
        # SE bests, except where that best is the reported alignment (same
        # global origin and strand, through rel).  A rescued mate is no
        # candidate, so nothing is left out for it.
        resc = takeS(st["resc"])
        same_rep = ((~resc)[None, :]
                    & ((st["se_ws"] - takeS(st["win_start"])[None, :])
                       == rel[:, w])
                    & (st["se_strand"] == takeS(st["strand"])[None, :]))
        others_w = torch.where((sid == w[None, :]) | same_rep, NEG_INF,
                               se_best)
        sec_rep = torch.maximum(takeS(st["second"]),
                                others_w.max(dim=0).values)
        g_second = torch.where(proper, sec_rep, sec_se)
        smin = _score_min(lens, params)
        se_aligned = (g_best >= smin) & (lens > 0)
        aligned = proper | se_aligned
        mq_se = mapq_v2(g_best, sec_se, sec_se >= smin, smin,
                        _score_perfect(lens, params))
        mq = torch.where(proper, mq_pair, mq_se)
        return {
            "aligned": aligned & (lens > 0),
            "strand": torch.where(proper, takeS(st["strand"]),
                                  tG(st["se_strand"])),
            "win_start": torch.where(proper, takeS(st["win_start"]),
                                     tG(st["se_ws"])),
            "score": torch.where(proper, takeS(st["score"]), g_best),
            "mapq": torch.where(aligned, mq, 0),
            "second": g_second,
            "has_second": g_second > NEG_INF // 2,
            "shard": torch.where(proper, w, wg),
            "resc": resc,
        }, se_aligned

    m1, a1 = merge_mate(st1, l1)
    m2, a2 = merge_mate(st2, l2)
    return m1, m2, {"proper": proper, "discordant": (~proper) & a1 & a2}


class ShardedMapper(Mapper):
    """Host orchestration over a ShardedIndex whose tensors lie on one
    device (a shard's genome slice goes where its index is); escalation,
    the host finish and SAM records are the unsharded mapper's (global
    positions appear only on the host)."""

    def __init__(self, sidx, genome_symbols: np.ndarray,
                 params: MapperParams = MapperParams(), ref_name: str = "ref",
                 contigs: dict | None = None):
        self._init_host(sidx.shards[0][0].bwt_words.device,
                        sidx.shards[0][1].k, genome_symbols, params,
                        ref_name, contigs)
        gp = self._genome_np  # the global host copy, int64-indexed
        lt_pad = len(gp) - self.n
        self._starts = np.asarray([s[3] for s in sidx.shards], np.int64)
        ends = [*self._starts[1:].tolist(), self.n]
        self.shard_state = []
        for i, (fm, ssa, lut, start, length) in enumerate(sidx.shards):
            span = ends[i] - start
            self.shard_state.append(dict(
                fm=fm, ssa=ssa, lut=lut, start=start, length=length,
                span=span,
                # ownership [lo, hi) in local origins: local 0 of a
                # non-first shard holds clamped duplicates (_shard_cands)
                own=(0 if i == 0 else 1, span + 1),
                g=torch.from_numpy(gp[start:start + length + lt_pad]).to(
                    fm.bwt_words.device),
                gw=pack_genome_words(gp[start:start + length],
                                     device=fm.bwt_words.device)))
        rel = self._starts[None, :] - self._starts[:, None]
        self._rel = torch.from_numpy(
            np.where(np.abs(rel) < 2**31 - 1, rel, -(2**31)).astype(
                np.int32)).to(self.device)

    def _dispatch_chunk(self, seqs, lens, quals, params=None):
        R = seqs.shape[0]
        params = params or self._chunk_params(
            lens.max() if len(lens) else seqs.shape[1],
            lens.min() if len(lens) else None)
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        jr, jl, jq = self._upload(seqs, lens, quals)
        ushift = (seqs.shape[1] - int(lens.max())
                  if len(lens) and lens.min() == lens.max() else -1)
        fwd = _sharded_top2(
            self._shard_candidates(jr, jl, jq, params, uniform_shift=ushift),
            jl, params)
        walk = _sharded_walk(self.shard_state, fwd["win_start"],
                             fwd["shard"], jr, jl, jq, fwd["strand"],
                             params=params, active=fwd["aligned"])
        return (seqs, lens, quals, fwd, walk, R)

    def _shard_candidates(self, jr, jl, jq, params, uniform_shift=-1):
        """Every shard's ownership-masked candidate stage over one
        uploaded chunk (strands and seeds made once)."""
        pre = stage_reads(jr, jl, jq, params=params,
                          uniform_shift=uniform_shift)
        return [_shard_cands(st, jr, jl, jq, params=params, pre=pre)
                for st in self.shard_state]

    def _finish_sharded(self, seqs, lens, quals, fwd, walk, R):
        """MapResults of one chunk, its win_start made global on the
        host (int64)."""
        fwd = dict(fwd, win_start=self._starts[_host(fwd["shard"])]
                   + _host(fwd["win_start"]).astype(np.int64))
        return self._finish(seqs, lens, quals, fwd, None, walk)[:R]

    def _finish_handle(self, handle):
        seqs, lens, quals, fwd, walk, R = handle
        return self._finish_sharded(seqs, lens, quals, fwd, walk, R), fwd

    def _collect_chunk(self, handle):
        seqs, lens, quals, fwd, walk, R = handle
        self.locate_dropped += int(fwd["locate_dropped"])
        self.overflowed += int(_host(fwd["overflow"])[:R].sum())
        results = self._finish_sharded(seqs, lens, quals, fwd, walk, R)
        # reads whose budgets overflowed on any shard re-map with
        # escalated budgets (Mapper._escalate_chunk)
        if self.ESCALATES and self.params.max_effort > 1:
            results = self._escalate_chunk(seqs, lens, quals, fwd, results,
                                           R)
        return results

    def _map_chunk_all(self, seqs, lens, quals, k):
        """-a over the shards: per-shard top-k lists merged into a global
        top-k (ownership keeps an overlap-visible hit once), one walk
        over the winners' shards."""
        R = seqs.shape[0]
        B = self.params.batch_size
        p = self.params
        seqs, lens, quals = self._pad_chunk(seqs, lens, quals)
        jr, jl, jq = self._upload(seqs, lens, quals)
        fwd = _sharded_all_merge(
            [_shard_all(c, params=p, k=k)
             for c in self._shard_candidates(jr, jl, jq, p)], jl, p, k)
        K = fwd["score"].shape[1]
        walk = _sharded_walk(
            self.shard_state, fwd["win_start"].reshape(-1),
            fwd["shard"].reshape(-1), jr.repeat_interleave(K, dim=0),
            jl.repeat_interleave(K), jq.repeat_interleave(K, dim=0),
            fwd["strand"].reshape(-1), params=p,
            active=fwd["valid"].reshape(-1))
        flat_fwd = {
            "aligned": _host(fwd["valid"]).reshape(-1),
            "strand": _host(fwd["strand"]).reshape(-1),
            "win_start": (self._starts[_host(fwd["shard"]).reshape(-1)]
                          + _host(fwd["win_start"]).reshape(-1)),
            "score": _host(fwd["score"]).reshape(-1),
            "second": np.zeros(B * K, np.int32),
            "has_second": np.zeros(B * K, bool),
            "mapq": np.zeros(B * K, np.int32),
        }
        results = self._finish(
            np.repeat(seqs, K, axis=0), np.repeat(lens, K),
            np.repeat(quals, K, axis=0), flat_fwd, None, walk)
        return self._group_all(results, min(R, B), K)


class PairedShardedMapper(ShardedMapper, PairedMapper):
    """Paired-end mapping over a sharded index: per-shard pe_map_batch
    with pair ownership by the leftmost mate (``span``), merged by
    _sharded_pe_merge, one walk per mate over the winners' shards; the
    pair policy and SAM records are PairedMapper's.

    One divergence from the single-index mapper, as in the reference:
    rescue anchors on each shard's own SE best, so where a mate's best
    anchors tie across shards the rescued pair can only improve on the
    single-index result, which rescues around one global anchor."""

    def __init__(self, *args, **kwargs):
        ShardedMapper.__init__(self, *args, **kwargs)
        self.rescued = 0  # pairs with a mate placed by window rescue
        self.rescue_dropped = 0  # pairs past a shard's rescue capacity
        need = (self.params.maxins + self.params.max_read_len
                + 2 * self.params.band_w + 8)
        for st in self.shard_state[:-1]:
            ov = st["length"] - st["span"]
            if ov < need:
                raise ValueError(
                    f"sharded PE needs shard overlap >= maxins + "
                    f"max_read_len + 2*band_w + 8 = {need}, got {ov}; "
                    "rebuild the index with --shard-overlap >= that")

    def _dispatch_pair_chunk(self, s1, l1, q1, s2, l2, q2):
        R = s1.shape[0]
        host, tensors = self._stage_pair_batch(s1, l1, q1, s2, l2, q2)
        m1, m2, pair = _sharded_pe_merge(
            self._shard_pairs(tensors), tensors[0][1], tensors[1][1],
            self._rel, self.params)
        walks = [(mate, _sharded_walk(self.shard_state, mate["win_start"],
                                      mate["shard"], *t, mate["strand"],
                                      params=self.params,
                                      active=mate["aligned"]))
                 for mate, t in zip((m1, m2), tensors)]
        return host, walks, pair, R

    def _shard_pairs(self, tensors):
        """Every shard's pe_map_batch over one uploaded pair chunk."""
        return [pe_map_batch(st["fm"], st["ssa"], st["gw"], st["g"],
                             *tensors[0], *tensors[1], params=self.params,
                             lut=st["lut"], span=st["own"])
                for st in self.shard_state]

    def _collect_pair_chunk(self, handle):
        host, walks, pair, R = handle
        self.locate_dropped += int(pair["locate_dropped"])
        self.rescue_dropped += int(pair["rescue_dropped"])
        self.rescued += int(_host(walks[0][0]["resc"]
                                  | walks[1][0]["resc"])[:R].sum())
        res1, res2 = [
            self._finish_sharded(*h, mate, walk, R)
            for (mate, walk), h in zip(walks, host)]
        proper = _host(pair["proper"])
        discordant = _host(pair["discordant"])
        info = [{"proper": bool(proper[i]), "discordant": bool(discordant[i])}
                for i in range(R)]
        return apply_pair_policy(res1, res2, info, host[0][1], host[1][1],
                                 self.params)

