"""Port's mapper stages against the JAX package on the CPU: map_batch and
traceback_walk_batch field by field (uniform and mixed-length batches),
runjump_walk on the same flags, and the copied parameter types."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alignment import types as jax_types
from nvbio_tpu.alignment.walk import runjump_walk as jax_runjump_walk
from nvbio_tpu.fmindex.build import build_fm_index, build_kmer_lut
from nvbio_tpu.models import mapper as jax_mapper
from nvbio_tpu.models import params as jax_params
from nvbio_tpu.utils.simulate import random_genome, simulate_reads
from nvbio_tpu_torch.alignment import types, walk
from nvbio_tpu_torch.alignment.batched import banded_directions_batch
from nvbio_tpu_torch.alignment.walk import runjump_walk
from nvbio_tpu_torch.io.index_file import index_from_numpy
from nvbio_tpu_torch.models import mapper, params
from nvbio_tpu_torch.strings.string_set import pack_reads

N_BP = 20_000
N_READS = 64
LUT_K = 8


def _genome():
    """Random genome with a 70-copy tandem array of a 150 bp unit (1%
    divergence): reads from it hold seeds over max_range hits, so their
    budgets overflow and the escalation round runs."""
    g = random_genome(N_BP, seed=31)
    rng = np.random.default_rng(4)
    for c in range(70):
        u = g[:150].copy()
        m = rng.random(150) < 0.01
        u[m] = rng.integers(0, 4, int(m.sum()))
        g[5000 + 150 * c: 5150 + 150 * c] = u
    return g


@pytest.fixture(scope="module")
def setup():
    g = _genome()
    fm, ssa = build_fm_index(g, sa_sample=4, bi_sample=True)
    lut = build_kmer_lut(g, k=LUT_K)
    kw = dict(seed_interval_fn="S", seed_interval_a=1.0,
              seed_interval_b=1.15, batch_size=N_READS, max_read_len=128,
              lut_k=LUT_K)
    jm = jax_mapper.Mapper(fm, ssa, g, params=jax_params.MapperParams(**kw),
                           use_pallas=False, lut=lut)
    tfm, tssa, tg, tlut = index_from_numpy(
        [np.asarray(x) for x in fm[:6]], [np.asarray(x) for x in ssa], g,
        [np.asarray(x) for x in lut])
    tm = mapper.Mapper(tfm, tssa, tg, params=params.MapperParams(**kw),
                       lut=tlut)
    sim = simulate_reads(g, N_READS, 100, seed=32, error_rate=0.02,
                         indel_rate=0.005)
    return jm, tm, sim


def _batch(sim, mixed):
    seqs = [s.astype(np.uint8) for s in sim["seqs"]]
    quals = list(sim["quals"])
    if mixed:
        lens = np.random.default_rng(5).integers(40, 101, N_READS)
        seqs = [s[:n] for s, n in zip(seqs, lens)]
        quals = [q[:n] for q, n in zip(quals, lens)]
    reads, lens, qmat, _ = pack_reads(seqs, quals, max_len=128)
    reads, qmat = mapper.Mapper._len_bucket(reads, lens, qmat)
    return reads, lens, qmat


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got.cpu() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), what)


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_map_batch_and_traceback_match_jax(setup, mixed):
    jm, tm, sim = setup
    reads, lens, qmat = _batch(sim, mixed)
    p = tm._chunk_params(lens.max(), lens.min())
    jp = jm._chunk_params(lens.max(), lens.min())
    assert (p.seed_slots > 0) == mixed
    ushift = -1 if mixed else reads.shape[1] - int(lens.max())
    jr, jl, jq = (jnp.asarray(reads), jnp.asarray(lens),
                  jnp.asarray(qmat))
    tr, tl, tq = (torch.from_numpy(reads), torch.from_numpy(lens).long(),
                  torch.from_numpy(qmat))
    want = jm._forward(jr, jl, jq, uniform_shift=ushift, params=jp)
    got = mapper.map_batch(tm.fm, tm.ssa, tm.gwords, tr, tl, tq, params=p,
                           lut=tm.lut, uniform_shift=ushift)
    for k in want:
        _eq(got[k], want[k], k)
    assert np.asarray(want["aligned"]).mean() > 0.8

    res_w, walk_w = jax_mapper.traceback_walk_batch(
        jm.genome, jnp.asarray(jm.n, jnp.int32), jr, jl, jq,
        want["win_start"], want["strand"], params=jp, use_pallas=False,
        active=want["aligned"])
    res_g, walk_g = mapper.traceback_walk_batch(
        tm.genome, tm.n, tr, tl, tq, got["win_start"], got["strand"],
        params=p, active=got["aligned"])
    for k in res_w:
        _eq(res_g[k], res_w[k], k)
    for k in walk_w:
        _eq(walk_g[k], walk_w[k], k)


def test_map_reads_results_match_jax(setup):
    """Host finish + escalation: MapResults equal the reference's."""
    jm, tm, sim = setup
    reads, lens, qmat = _batch(sim, mixed=False)
    assert tm.map_reads(reads, lens, qmat) == [
        mapper.MapResult(**dataclasses.asdict(r))
        for r in jm.map_reads(reads, lens, qmat)]
    assert tm.escalated == jm.escalated > 0
    assert tm.overflowed == jm.overflowed


def test_runjump_walk_matches_jax_on_random_flags():
    """Random flag matrices reach every terminal rule of the automaton
    (origin, unclosed runs, runs leaving the band)."""
    rng = np.random.default_rng(9)
    R, rows, stride = 96, 24, 15
    dirs = rng.integers(0, 16, (R, rows * stride)).astype(np.uint8)
    i0 = rng.integers(0, rows + 1, R).astype(np.int32)
    k0 = rng.integers(-1, stride + 1, R).astype(np.int32)
    active = rng.random(R) < 0.9
    for max_runs in (None, 9):
        want = jax_runjump_walk(jnp.asarray(dirs), stride, jnp.asarray(i0),
                                jnp.asarray(k0), active=jnp.asarray(active),
                                max_runs=max_runs)
        got = runjump_walk(torch.from_numpy(dirs), stride,
                           torch.from_numpy(i0), torch.from_numpy(k0),
                           active=torch.from_numpy(active),
                           max_runs=max_runs)
        for g, w in zip(got, want):
            _eq(g, w, "walk")


@pytest.fixture()
def one_torch_thread():
    """One intra-op torch thread: the plain DP runs ~30 small ops per
    pattern row, which slow down many times over when the test workers'
    thread pools fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_runjump_walk_long_patterns_match_jax(one_torch_thread,
                                              monkeypatch):
    """Long-pattern flags (Lp 2016, STRIDE 127): the walk, its run
    descriptors built in int32 one block of lanes at a time, equals the
    JAX walk — from the DP's sinks over real flags and from random cells
    over random flags."""
    rng = np.random.default_rng(12)
    R, rows, w = 4, 2016, 63
    stride = 2 * w + 1
    texts = rng.integers(0, 4, (R, rows + 2 * w)).astype(np.int8)
    pats = np.stack([np.roll(texts[r, w:w + rows], int(s))
                     for r, s in enumerate(rng.integers(-20, 21, R))])
    mut = rng.random(pats.shape) < 0.02
    pats[mut] = rng.integers(0, 4, int(mut.sum()))
    lens = np.full(R, rows, np.int32)
    res, dirs = banded_directions_batch(
        torch.from_numpy(pats), torch.from_numpy(lens),
        torch.from_numpy(texts), torch.from_numpy(lens + 2 * w),
        scheme=types.GotohScheme(), atype=types.AlignmentType.SEMI_GLOBAL,
        band_w=w)
    i0 = res["p_end"].long()
    cases = [(dirs.reshape(R, -1), i0, res["t_end"].long() - i0 + w),
             (torch.from_numpy(rng.integers(0, 16, (R, rows * stride))
                               .astype(np.uint8)),
              torch.from_numpy(rng.integers(0, rows + 1, R)),
              torch.from_numpy(rng.integers(0, stride, R)))]
    jwalk = jax.jit(jax_runjump_walk, static_argnames=("STRIDE", "max_runs"))
    monkeypatch.setattr(walk, "_BLOCK_CELLS", rows * stride)  # 1 lane/block
    runs = []
    for flags, i, k in cases:
        want = jwalk(jnp.asarray(flags.numpy()), stride,
                     jnp.asarray(i.numpy(), jnp.int32),
                     jnp.asarray(k.numpy(), jnp.int32), max_runs=300)
        got = runjump_walk(flags, stride, i, k, max_runs=300)
        for g, wv in zip(got, want):
            _eq(g, wv, "walk")
        runs.append(int((got[3] > 0).sum()))
    assert runs[0] > 2 * R  # the DP's traces cross the shifted ends


def test_copied_types_match_reference():
    def spec(cls):
        return [(f.name, dataclasses.asdict(f.default)
                 if dataclasses.is_dataclass(f.default) else f.default)
                for f in dataclasses.fields(cls)]

    assert spec(params.MapperParams) == spec(jax_params.MapperParams)
    assert spec(types.GotohScheme) == spec(jax_types.GotohScheme)
    assert ({a.name: a.value for a in types.AlignmentType}
            == {a.name: a.value for a in jax_types.AlignmentType})
    assert types.NEG_INF == jax_types.NEG_INF
    assert (dataclasses.asdict(types.BOWTIE2_LOCAL_SCHEME)
            == dataclasses.asdict(jax_types.BOWTIE2_LOCAL_SCHEME))
    s = types.GotohScheme(gap_open=3, ref_gap_extend=7)
    js = jax_types.GotohScheme(gap_open=3, ref_gap_extend=7)
    assert types.gap_penalties(s) == jax_types.gap_penalties(js)
    assert params.MapperParams(local=True).atype.value == \
        jax_params.MapperParams(local=True).atype.value
    for fn in "CLSG":
        assert params.eval_simple_func(fn, 1.0, 1.15, 77) == \
            jax_params.eval_simple_func(fn, 1.0, 1.15, 77)


def test_score_min_matches_jax():
    lens = np.arange(0, 260, dtype=np.int32)
    for fn, a, b in [("L", -0.6, -0.6), ("S", 1.0, 1.15), ("G", 20.0, 8.0),
                     ("C", -7.5, 0.0)]:
        kw = dict(score_min_fn=fn, score_min_a=a, score_min_b=b)
        got = mapper._score_min(torch.from_numpy(lens),
                                params.MapperParams(**kw))
        want = jax_mapper._score_min(jnp.asarray(lens),
                                     jax_params.MapperParams(**kw))
        _eq(got, want, fn)
        for L in (1, 50, 100, 151):
            assert mapper.score_min_host(L, params.MapperParams(**kw)) == \
                jax_mapper.score_min_host(L, jax_params.MapperParams(**kw))
