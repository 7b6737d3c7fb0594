"""The port's sharded index and sharded mappers against the JAX package on
the CPU, exact equality throughout (every output is an integer or a
string): single-end, -a and paired-end results of ShardedMapper and
PairedShardedMapper equal nvbio_tpu.models.sharded_mapper's field by
field (tests/test_sharded.py's genome and shards: 150 kb at shard_bp
60 000, overlap 2048, 3 shards); pe_map_batch's ownership span and the
cross-shard PE merge equal the reference's per shard and merged; the
boundary rescue, the overlap guard, the tail-sliver fold and the
escalation on a repeat genome (tests/test_repeat_stress.py:132) as the
reference; index files cross between the packages both ways; and a
sharded run agrees per read with an unsharded one."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.fmindex import sharded as jax_sharded
from nvbio_tpu.models import paired as jax_paired
from nvbio_tpu.models import sharded_mapper as jax_sm
from nvbio_tpu.models.params import MapperParams as JaxParams
from nvbio_tpu.utils.simulate import random_genome, simulate_pairs
from nvbio_tpu_torch.fmindex import sharded
from nvbio_tpu_torch.models import paired, sharded_mapper
from nvbio_tpu_torch.models.mapper import Mapper, MapResult
from nvbio_tpu_torch.models.params import MapperParams
from nvbio_tpu_torch.strings.string_set import pack_reads

SHARDS = dict(shard_bp=60_000, overlap=2048, sa_sample=16, lut_k=8)
BASE = dict(batch_size=64, sa_sample=16, max_candidates=8, lut_k=8)
PE = dict(BASE, minins=0, maxins=400)
STRADDLE = [59_820, 59_900, 59_960, 59_990, 119_820, 119_900, 119_960,
            119_990]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as the other port tests (the plain DP's
    small per-row ops slow down when the workers' pools fight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The genome of tests/test_sharded.py with its shards built by each
    package, and 52 reads: 48 anywhere, 4 across both boundaries."""
    genome = random_genome(150_000, seed=101)
    rng = np.random.default_rng(102)
    starts = list(rng.integers(0, 150_000 - 100, 48))
    starts += [59_950, 59_990, 119_950, 119_990]
    seqs = []
    for s in starts:
        frag = genome[s:s + 100].copy()
        p = int(rng.integers(10, 90))
        frag[p] = (frag[p] + 1) % 4
        seqs.append(frag)
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(100, 35, np.uint8)] * len(seqs))
    return {"genome": genome, "reads": (reads, lens, quals),
            "starts": starts,
            "jidx": jax_sharded.build_sharded_index(genome, **SHARDS),
            "tidx": sharded.build_sharded_index(genome, **SHARDS)}


def _results(rs):
    """The reference's MapResults as the port's dataclass."""
    return [MapResult(**dataclasses.asdict(r)) for r in rs]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_index(tidx, jidx):
    """Every shard's arrays, start and length equal (uint32 bits held in
    int32 by the port)."""
    assert len(tidx.shards) == len(jidx.shards)
    for (tfm, tssa, tlut, *tspan), (jfm, jssa, jlut, *jspan) in zip(
            tidx.shards, jidx.shards):
        assert tspan == list(jspan)
        pairs = [(tfm.bwt_words, jfm.bwt_words), (tfm.occ_abs, jfm.occ_abs),
                 (tfm.occ_sub, jfm.occ_sub), (tfm.C, jfm.C),
                 (tssa.mark_words, jssa.mark_words),
                 (tssa.mark_abs, jssa.mark_abs), (tssa.vals, jssa.vals)]
        pairs += list(zip(tlut or (), jlut or ()))
        assert (tlut is None) == (jlut is None)
        for got, want in pairs:
            want = _np(want)
            np.testing.assert_array_equal(
                _np(got), want.view(np.int32) if want.dtype == np.uint32
                else want)
        assert (tfm.primary, tfm.n) == (int(jfm.primary), int(jfm.n))
        assert (tssa.k, tssa.bi) == (int(jssa.k), int(jssa.bi))


def test_build_matches_reference(setup):
    _same_index(setup["tidx"], setup["jidx"])
    assert (setup["tidx"].n_total, setup["tidx"].sa_sample,
            setup["tidx"].lut_k) == (150_000, 16, 8)


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_se_matches_reference(setup, mixed):
    """ShardedMapper.map_reads: every MapResult field and the locate,
    overflow and escalation counters; mixed read lengths take the
    per-read seed interval (-i S,1,1.15)."""
    genome = setup["genome"]
    reads, lens, quals = setup["reads"]
    kw = dict(BASE)
    if mixed:
        lens = np.random.default_rng(5).integers(40, 101, len(lens)).astype(
            lens.dtype)
        tail = np.arange(reads.shape[1]) >= lens[:, None]
        reads, quals = np.where(tail, 7, reads), np.where(tail, 0, quals)
        kw.update(seed_interval_fn="S", seed_interval_a=1.0,
                  seed_interval_b=1.15)
    jm = jax_sm.ShardedMapper(setup["jidx"], genome,
                              params=JaxParams(**kw), use_pallas=False)
    tm = sharded_mapper.ShardedMapper(setup["tidx"], genome,
                                      params=MapperParams(**kw))
    want = jm.map_reads(reads, lens, quals.astype(np.int32))
    got = tm.map_reads(reads, lens, quals)
    assert got == _results(want)
    assert (tm.locate_dropped, tm.overflowed, tm.escalated) == (
        jm.locate_dropped, jm.overflowed, jm.escalated)
    assert sum(r.aligned for r in got) >= 0.9 * len(got)


def test_all_matches_reference(setup):
    """-a: per read the same alignments in the same order, on a genome
    with a 20 kb block of shard 0 copied into shard 2."""
    g = setup["genome"].copy()
    g[125_000:145_000] = g[10_000:30_000]
    rng = np.random.default_rng(7)
    starts = list(rng.integers(10_000, 30_000 - 100, 12))
    starts += list(rng.integers(60_000, 100_000 - 100, 8))
    starts += [59_960, 119_980]
    reads, lens, quals, _ = pack_reads(
        [g[s:s + 100].copy() for s in starts],
        [np.full(100, 35, np.uint8)] * len(starts))
    jm = jax_sm.ShardedMapper(jax_sharded.build_sharded_index(g, **SHARDS),
                              g, params=JaxParams(**BASE), use_pallas=False)
    tm = sharded_mapper.ShardedMapper(sharded.build_sharded_index(g, **SHARDS),
                                      g, params=MapperParams(**BASE))
    want = jm.map_reads_all(reads, lens, quals.astype(np.int32), max_alns=6)
    got = tm.map_reads_all(reads, lens, quals, max_alns=6)
    assert got == [_results(a) for a in want]
    assert sum(len(a) > 1 for a in got) >= 10


def _straddling_pairs(genome):
    """56 simulated pairs, the last 8 fragments across the boundaries,
    and every 12th base of mate 2 flipped on every fourth pair so that
    rescue places it."""
    sim = simulate_pairs(genome, 56, 100, insert_mean=250, insert_sd=25,
                         seed=12)
    s1, s2 = sim["seqs1"].copy(), sim["seqs2"].copy()
    for j, fs in enumerate(STRADDLE):
        s1[48 + j] = genome[fs:fs + 100]
        frag2 = genome[fs + 150:fs + 250]
        s2[48 + j] = np.where(frag2 < 4, 3 - frag2, frag2)[::-1]
    for k in range(4, 100, 12):
        s2[::4, k] = (s2[::4, k] + 1) % 4
    return s1, s2, np.full(56, 100, np.int32), np.full((56, 100), 35,
                                                      np.uint8)


def _rescue_pairs(genome):
    """tests/test_sharded.py:158: mate 1 forward left of a boundary with
    its seeds broken, mate 2 reverse anchored just right of it (and two
    pairs inside shards)."""
    fss = [59_760, 59_700, 119_760, 119_700, 59_810, 119_810, 30_000,
           90_000]
    s1 = np.zeros((8, 100), np.uint8)
    s2 = np.zeros((8, 100), np.uint8)
    for i, fs in enumerate(fss):
        m1 = genome[fs:fs + 100].copy()
        for k in range(4, 100, 12):
            m1[k] = (m1[k] + 1) % 4
        s1[i] = m1
        frag2 = genome[fs + 250:fs + 350]
        s2[i] = np.where(frag2 < 4, 3 - frag2, frag2)[::-1]
    return fss, (s1, s2, np.full(8, 100, np.int32),
                 np.full((8, 100), 35, np.uint8))


def _pe_mappers(setup):
    g = setup["genome"]
    return (jax_sm.PairedShardedMapper(setup["jidx"], g,
                                       params=JaxParams(**PE),
                                       use_pallas=False),
            sharded_mapper.PairedShardedMapper(setup["tidx"], g,
                                               params=MapperParams(**PE)))


@pytest.mark.parametrize("data", ["straddle", "boundary-rescue"])
def test_pe_matches_reference(setup, data):
    """map_pairs: both mates' MapResults and the pair info equal the
    reference's; straddling pairs are proper at their origin, and the
    boundary-rescue pairs are rescued by the shard left of the
    boundary."""
    jm, tm = _pe_mappers(setup)
    if data == "straddle":
        s1, s2, ln, q = _straddling_pairs(setup["genome"])
        origins = {48 + j: fs for j, fs in enumerate(STRADDLE)}
    else:
        fss, (s1, s2, ln, q) = _rescue_pairs(setup["genome"])
        origins = dict(enumerate(fss))
    w1, w2, winfo = jm.map_pairs(s1, ln, q, s2, ln, q)
    g1, g2, ginfo = tm.map_pairs(s1, ln, q, s2, ln, q)
    assert (g1, g2, ginfo) == (_results(w1), _results(w2), winfo)
    for i, fs in origins.items():
        assert ginfo[i]["proper"] and g1[i].pos == fs, i
    assert tm.rescued > 0 and tm.locate_dropped == jm.locate_dropped


def test_pe_span_and_merge_match_reference(setup):
    """pe_map_batch with each shard's ownership span equals the
    reference's field by field, _sharded_pe_merge equals the reference's
    merge, and the port's rescued and rescue_dropped counters are those
    of the reference's per-shard outputs at the winner shard."""
    g = setup["genome"]
    jm, tm = _pe_mappers(setup)
    s1, s2, ln, q = _straddling_pairs(g)
    _, _, jargs = jm._stage_pair_batch(s1, ln, q, s2, ln, q)
    _, tensors = tm._stage_pair_batch(s1, ln, q, s2, ln, q)
    jouts, touts = [], []
    for jst, tst in zip(jm.shard_state, tm.shard_state):
        span = (jnp.asarray(jst["own_lo"], jnp.int32),
                jnp.asarray(jst["own_hi"], jnp.int32))
        assert tst["own"] == (jst["own_lo"], jst["own_hi"])
        jouts.append(jax_paired.pe_map_batch(
            jst["fm"], jst["ssa"], jst["g"], *jargs, params=jm.params,
            use_pallas=False, lut=jst["lut"], span=span))
        touts.append(paired.pe_map_batch(
            tst["fm"], tst["ssa"], tst["gw"], tst["g"], *tensors[0],
            *tensors[1], params=tm.params, lut=tst["lut"], span=tst["own"]))
        for w, got in zip(jouts[-1], touts[-1]):
            assert set(got) == set(w)
            for k in w:
                np.testing.assert_array_equal(_np(got[k]), _np(w[k]),
                                              err_msg=k)
    want = jax_sm._sharded_pe_merge(jouts, jargs[1], jargs[4], jm._rel,
                                    params=jm.params)
    got = sharded_mapper._sharded_pe_merge(touts, tensors[0][1],
                                           tensors[1][1], tm._rel, tm.params)
    for w, gt in zip(want, got):
        for k in w:
            np.testing.assert_array_equal(_np(gt[k]), _np(w[k]), err_msg=k)
    np.testing.assert_array_equal(_np(tm._rel), _np(jm._rel))
    proper = _np(want[2]["proper"])
    resc = np.zeros(len(proper), bool)
    for m, mate in enumerate(want[:2]):
        stacked = np.stack([_np(o[m]["resc"]) for o in jouts])
        resc |= proper & stacked[_np(mate["shard"]), np.arange(len(proper))]
    assert resc.sum() > 0
    np.testing.assert_array_equal(_np(got[0]["resc"] | got[1]["resc"]), resc)
    assert int(got[2]["rescue_dropped"]) == sum(
        int(o[2]["rescue_dropped"]) for o in jouts)


def test_overlap_guard(setup):
    idx = sharded.build_sharded_index(setup["genome"], shard_bp=60_000,
                                      overlap=256, sa_sample=16, lut_k=0)
    with pytest.raises(ValueError, match="overlap"):
        sharded_mapper.PairedShardedMapper(
            idx, setup["genome"], params=MapperParams(batch_size=64,
                                                      sa_sample=16,
                                                      maxins=400))


def test_tail_sliver_folds_left(tmp_path):
    """_shard_bounds as the reference's (a tail no longer than the
    overlap folds into the previous shard); reads in and across the
    folded tail map as the reference; a manifest holding a sliver shard
    folds at load in both packages."""
    for n, bp, ov in ((61_024, 30_000, 1024), (61_025, 30_000, 1024),
                      (60_000, 30_000, 0), (100, 1000, 10), (5, 2, 3)):
        assert sharded._shard_bounds(n, bp, ov) == \
            jax_sharded._shard_bounds(n, bp, ov)
    genome = random_genome(2 * 30_000 + 1024, seed=707)
    kw = dict(batch_size=32, sa_sample=16, max_candidates=8, lut_k=8)
    sh = dict(shard_bp=30_000, overlap=1024, sa_sample=16, lut_k=8)
    tidx = sharded.build_sharded_index(genome, **sh)
    assert len(tidx.shards) == 2
    assert tidx.shards[-1][3] + tidx.shards[-1][4] == len(genome)
    starts = [60_000 - 80, 60_000 - 40, 60_000 + 900, len(genome) - 100,
              15_000]
    reads, lens, quals, _ = pack_reads(
        [genome[s:s + 100].copy() for s in starts],
        [np.full(100, 35, np.uint8)] * len(starts))
    jm = jax_sm.ShardedMapper(jax_sharded.build_sharded_index(genome, **sh),
                              genome, params=JaxParams(**kw),
                              use_pallas=False)
    tm = sharded_mapper.ShardedMapper(tidx, genome, params=MapperParams(**kw))
    got = tm.map_reads(reads, lens, quals)
    assert got == _results(jm.map_reads(reads, lens, quals.astype(np.int32)))
    assert [r.pos for r in got] == starts

    prefix = str(tmp_path / "t")
    sharded.save_sharded_index(prefix, tidx, genome, ["c"], [len(genome)])
    man = json.load(open(prefix + ".manifest.json"))
    last = man["shards"][-1]
    man["shards"].append({"file": last["file"],
                          "start": last["start"] + last["length"] - 512,
                          "length": 512})
    json.dump(man, open(prefix + ".manifest.json", "w"))
    assert len(sharded.load_sharded_index(prefix)[0].shards) == 2
    assert len(jax_sharded.load_sharded_index(prefix)[0].shards) == 2


@pytest.mark.parametrize("max_effort", [1, 2])
def test_escalation_matches_reference(max_effort):
    """tests/test_repeat_stress.py:132's genome (120 copies of a 400 bp
    element, all in shard 0): round-1 losses and the escalation round's
    recoveries equal the reference's, counters included."""
    rng = np.random.default_rng(46)
    element = rng.integers(0, 4, 400).astype(np.uint8)
    parts = []
    for _ in range(120):
        parts.append(element)
        parts.append(rng.integers(0, 4, 100).astype(np.uint8))
    parts.append(rng.integers(0, 4, 120_000).astype(np.uint8))
    genome = np.concatenate(parts)
    seqs = [element[50:150].copy() for _ in range(6)]
    seqs += [genome[70_000:70_100].copy(), genome[130_000:130_100].copy()]
    reads, lens, quals, _ = pack_reads(
        seqs, [np.full(100, 35, np.uint8)] * len(seqs), max_len=128)
    kw = dict(batch_size=8, sa_sample=8, max_candidates=8,
              max_effort=max_effort)
    sh = dict(shard_bp=(len(genome) + 2) // 3, overlap=2048, sa_sample=8)
    jm = jax_sm.ShardedMapper(jax_sharded.build_sharded_index(genome, **sh),
                              genome, params=JaxParams(**kw),
                              use_pallas=False)
    tm = sharded_mapper.ShardedMapper(
        sharded.build_sharded_index(genome, **sh), genome,
        params=MapperParams(**kw))
    got = tm.map_reads(reads, lens, quals)
    assert got == _results(jm.map_reads(reads, lens, quals.astype(np.int32)))
    assert (tm.escalated, tm.overflowed, tm.locate_dropped) == (
        jm.escalated, jm.overflowed, jm.locate_dropped)
    assert sum(r.aligned for r in got[:6]) == (0 if max_effort == 1 else 6)


@pytest.mark.parametrize("way", ["reference-to-port", "port-to-reference"])
def test_index_files_cross_packages(setup, tmp_path, way):
    """Shard files written by one package load in the other: the same
    manifest and arrays, the same mapping; a --lut-k rebuild at load
    gives the reference's tables."""
    genome = setup["genome"]
    prefix = str(tmp_path / "x")
    writer = (jax_sharded.save_sharded_index if way == "reference-to-port"
              else sharded.save_sharded_index)
    idx = setup["jidx"] if way == "reference-to-port" else setup["tidx"]
    writer(prefix, idx, genome, ["c1", "c2"], [70_000, 80_000])
    tidx, tg, tman = sharded.load_sharded_index(prefix)
    jidx, jg, jman = jax_sharded.load_sharded_index(prefix)
    assert tman == jman
    np.testing.assert_array_equal(tg, jg)
    _same_index(tidx, jidx)
    _same_index(tidx, setup["jidx"])
    reads, lens, quals = setup["reads"]
    jm = jax_sm.ShardedMapper(jidx, jg.astype(np.uint8),
                              params=JaxParams(**BASE), use_pallas=False)
    tm = sharded_mapper.ShardedMapper(tidx, tg.astype(np.uint8),
                                      params=MapperParams(**BASE))
    assert tm.map_reads(reads, lens, quals) == _results(
        jm.map_reads(reads, lens, quals.astype(np.int32)))
    tidx10, _, tman10 = sharded.load_sharded_index(prefix, lut_k=10)
    jidx10, _, jman10 = jax_sharded.load_sharded_index(prefix, lut_k=10)
    assert tman10 == jman10 and tidx10.lut_k == 10
    _same_index(tidx10, jidx10)


def test_strip_bi_ssa_matches_reference():
    """A bi-marked SSA stripped to mono marks: the reference's arrays,
    and the mono build's."""
    from nvbio_tpu.fmindex.build import build_fm_index
    from nvbio_tpu_torch.io.index_file import index_from_numpy

    g = random_genome(40_000, seed=91)
    _, jbi = build_fm_index(g, sa_sample=8, bi_sample=True)
    _, jmono = build_fm_index(g, sa_sample=8, bi_sample=False)
    _, tbi, _, _ = index_from_numpy(
        [np.zeros(1, np.int32)] * 4 + [0, 0], [np.asarray(x) for x in jbi],
        g)
    got = sharded._strip_bi_ssa(tbi)
    want = jax_sharded._strip_bi_ssa(jbi)
    for field in ("mark_words", "mark_abs", "vals"):
        w = np.asarray(getattr(want, field))
        w = w.view(np.int32) if w.dtype == np.uint32 else w
        np.testing.assert_array_equal(_np(getattr(got, field)), w)
        m = np.asarray(getattr(jmono, field))
        np.testing.assert_array_equal(
            _np(getattr(got, field)),
            m.view(np.int32) if m.dtype == np.uint32 else m)
    assert (got.k, got.bi) == (8, 0)


def test_sharded_agrees_with_unsharded(setup):
    """The port's sharded and unsharded mappers on one genome: per read
    the same (aligned, pos, strand, CIGAR, score, MD, NM); the boundary
    reads at their origins."""
    from nvbio_tpu_torch.fmindex.build import build_fm_arrays, build_kmer_lut
    from nvbio_tpu_torch.io.index_file import index_from_numpy

    genome = setup["genome"]
    reads, lens, quals = setup["reads"]
    fm_f, ssa_f = build_fm_arrays(genome, sa_sample=16)
    fm, ssa, _, lut = index_from_numpy(fm_f, (*ssa_f, 16, 0), genome,
                                       build_kmer_lut(genome, k=8))
    single = Mapper(fm, ssa, genome, params=MapperParams(**BASE), lut=lut)
    a = single.map_reads(reads, lens, quals)
    b = sharded_mapper.ShardedMapper(setup["tidx"], genome,
                                     params=MapperParams(**BASE)).map_reads(
                                         reads, lens, quals)

    def key(r):
        return (r.aligned, r.pos, r.strand, r.cigar, r.score, r.md, r.nm)

    assert [key(r) for r in a] == [key(r) for r in b]
    for i in range(len(b) - 4, len(b)):
        assert b[i].aligned and b[i].pos == setup["starts"][i]
