"""Port's host index build, container and FM-index queries against the
JAX package: equal arrays, equal SA ranges, equal positions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvbio_tpu.fmindex import build as jax_build
from nvbio_tpu.fmindex.index import backward_search as jax_backward_search
from nvbio_tpu.fmindex.index import locate as jax_locate
from nvbio_tpu.io import index_file as jax_index_file
from nvbio_tpu_torch import native as port_native
from nvbio_tpu_torch.fmindex import build
from nvbio_tpu_torch.fmindex.index import backward_search, locate, rank
from nvbio_tpu_torch.io import index_file
from nvbio_tpu_torch.sufsort import sa

N_BP = 20_000
LUT_K = 6


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(20).integers(0, 4, N_BP).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_index(genome):
    fm, ssa = jax_build.build_fm_index(genome, sa_sample=4, bi_sample=True)
    lut = jax_build.build_kmer_lut(genome, k=LUT_K)
    return fm, ssa, lut


def _assert_fields_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("bi", [True, False], ids=["bi", "mono"])
def test_build_arrays_match_jax(genome, native, bi, monkeypatch):
    """Native passes and numpy fallbacks both give the JAX build's
    arrays (the JAX side runs its own native path)."""
    want_fm, want_ssa = jax_build.build_fm_arrays(genome, sa_sample=4,
                                                  bi_sample=bi)
    want_lut = jax_build.build_kmer_lut(genome, k=LUT_K)
    if not native:
        for name in ("ssa_build_native", "kmer_hist_native",
                     "fm_bwt_occ_native"):
            monkeypatch.setattr(build, name, lambda *a, **k: None)
        # sufsort.sa (the suffix sort) imports SA-IS at each call
        monkeypatch.setattr(port_native, "sais_native", lambda *a, **k: None)
    got_fm, got_ssa = build.build_fm_arrays(genome, sa_sample=4,
                                            bi_sample=bi)
    _assert_fields_equal(got_fm, want_fm)
    _assert_fields_equal(got_ssa, want_ssa)
    _assert_fields_equal(build.build_kmer_lut(genome, k=LUT_K), want_lut)


def test_suffix_array_fallback_matches_native(genome):
    t = genome[:3000]
    np.testing.assert_array_equal(sa.suffix_array_pd(t), sa.suffix_array(t))


def test_jax_written_npz_loads(tmp_path, genome, jax_index):
    fm, ssa, lut = jax_index
    path = str(tmp_path / "j.npz")
    jax_index_file.save_index(path, fm, ssa, genome.astype(np.int8), ["c"],
                              [N_BP], 4, lut=lut, lut_k=LUT_K)
    tfm, tssa, g, meta = index_file.load_index(path)
    np.testing.assert_array_equal(g, genome.astype(np.int8))
    assert (meta["sa_sample"], meta["sa_bi"], meta["lut_k"]) == (4, 1, LUT_K)
    assert (tssa.k, tssa.bi, tfm.n, tfm.primary) == (4, 1, N_BP,
                                                      int(fm.primary))
    np.testing.assert_array_equal(tfm.bwt_words.numpy().view(np.uint32),
                                  np.asarray(fm.bwt_words))
    np.testing.assert_array_equal(tssa.vals.numpy(), np.asarray(ssa.vals))
    np.testing.assert_array_equal(meta["lut"][1].numpy(),
                                  np.asarray(lut[1]))
    # and the port's writer round-trips through the JAX loader
    path2 = str(tmp_path / "t.npz")
    index_file.save_index(path2, [tfm.bwt_words, tfm.occ_abs, tfm.occ_sub,
                                  tfm.C, tfm.primary, tfm.n],
                          [tssa.mark_words, tssa.mark_abs, tssa.vals],
                          g, ["c"], [N_BP], 4, sa_bi=1, lut=meta["lut"],
                          lut_k=LUT_K)
    jfm, jssa, jg, jmeta = jax_index_file.load_index(path2)
    for a, b in zip(jfm[:6], fm[:6]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jssa[:3], ssa[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _seeds(genome, n_seeds, seed_len, rng):
    pos = rng.integers(0, N_BP - seed_len, n_seeds)
    seeds = genome[pos[:, None] + np.arange(seed_len)].astype(np.int8)
    mut = rng.random(seeds.shape) < 0.03
    seeds[mut] = rng.integers(0, 5, int(mut.sum()))  # mismatches and N
    return seeds


@pytest.mark.parametrize("use_lut", [True, False], ids=["lut", "no_lut"])
def test_backward_search_matches_jax(genome, jax_index, use_lut):
    fm, ssa, lut = jax_index
    tfm, tssa, _, tlut = index_file.index_from_numpy(
        [np.asarray(x) for x in fm[:6]], [np.asarray(x) for x in ssa],
        genome, [np.asarray(x) for x in lut])
    seeds = _seeds(genome, 2000, 16, np.random.default_rng(1))
    kw = dict(lut=lut, lut_k=LUT_K) if use_lut else {}
    tkw = dict(lut=tlut, lut_k=LUT_K) if use_lut else {}
    lo, hi = jax_backward_search(fm, jnp.asarray(seeds), **kw)
    tlo, thi = backward_search(tfm, torch.from_numpy(seeds), **tkw)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(hi))
    assert (np.asarray(hi) > np.asarray(lo)).mean() > 0.4


def test_locate_and_rank_match_jax(genome, jax_index):
    fm, ssa, _ = jax_index
    tfm, tssa, _, _ = index_file.index_from_numpy(
        [np.asarray(x) for x in fm[:6]], [np.asarray(x) for x in ssa],
        genome)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, N_BP + 1, 2000).astype(np.int32)
    got = locate(tfm, tssa, torch.from_numpy(rows), k_sample=4)
    want = jax_locate(fm, ssa, jnp.asarray(rows), k_sample=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every position is a true suffix-array entry of its row
    sa_full = np.concatenate([[N_BP], sa.suffix_array(genome)])
    np.testing.assert_array_equal(got.numpy(), sa_full[rows])
    from nvbio_tpu.fmindex.index import rank as jax_rank
    c = rng.integers(0, 4, 2000)
    want_r = jax_rank(fm, jnp.asarray(c, jnp.int32), jnp.asarray(rows))
    got_r = rank(tfm, torch.from_numpy(c), torch.from_numpy(rows).long())
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
