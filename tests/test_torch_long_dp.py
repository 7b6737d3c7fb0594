"""K4 in the port (``ops/long_dp.py`` on CPU tensors, i.e. its plain
versions) against the JAX package's K4 (``banded_score_long_pallas`` and
``banded_directions_long_pallas`` in interpret mode, as
tests/test_long_read.py runs them).  Tolerance: exact, because every
output is an integer: score, p_end and t_end bit-equal, and the port's
run-jump walk over its flags gives the same runs as the JAX walk over the
JAX kernel's flags.  Also: ``route()``, the band-reach rule against
``nvbio_tpu.ops.long_dp._band_fits``, and the sentinel-floor guard.  The
CUDA kernel is held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alignment.types import (AlignmentType as JAType,
                                       GotohScheme as JScheme)
from nvbio_tpu.alignment.walk import runjump_walk
from nvbio_tpu.ops.long_dp import (_band_fits, _check_long,
                                   banded_directions_long_pallas,
                                   banded_score_long_pallas)
from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
from nvbio_tpu_torch.alignment.walk import runjump_walk as torch_walk
from nvbio_tpu_torch.ops import banded_dp, long_dp

NB = 6
SCHEMES = {
    AlignmentType.SEMI_GLOBAL: GotohScheme(),
    AlignmentType.LOCAL: GotohScheme(match=2),
    AlignmentType.GLOBAL: GotohScheme(),
}
ATYPES = list(SCHEMES)
IDS = [a.name.lower() for a in ATYPES]
#: one compiled program per flag shape, not an op-by-op eager walk
jax_runjump_walk = jax.jit(runjump_walk, static_argnames=("STRIDE",))


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """The long-kernel interpret compiles get a clean XLA:CPU slate, as
    tests/conftest.py gives tests/test_long_read.py."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the plain DP runs ~30 small ops per
    pattern row, which slow down many times over when the test workers'
    thread pools fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _long_batch(lp, band_w, seed, atype):
    """Patterns with substitutions, N and a few indels inside their text
    windows; one zero-length lane; GLOBAL window lengths within the band
    of each pattern's, so that its goal cell has a path."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(lp - lp // 10, lp + 1, NB).astype(np.int32)
    plens[1] = 0
    pats = rng.integers(0, 4, (NB, lp)).astype(np.int8)
    quals = rng.integers(0, 42, (NB, lp)).astype(np.uint8)
    lt = lp + 2 * band_w
    texts = rng.integers(0, 4, (NB, lt)).astype(np.int8)
    for b in range(NB):
        t = pats[b, :max(plens[b], 8)].copy()
        for _ in range(lp // 40):
            t[rng.integers(0, len(t))] = rng.integers(0, 5)
        for _ in range(3):
            p = rng.integers(1, len(t) - 2)
            t = (np.concatenate([t[:p], t[p + 1:]]) if rng.random() < 0.5
                 else np.concatenate([t[:p], [rng.integers(0, 4)], t[p:]]))
        texts[b, :min(len(t), lt)] = t[:lt]
    tlens = np.full(NB, lt, np.int32)
    if atype == AlignmentType.GLOBAL:
        tlens = np.clip(plens + rng.integers(-band_w // 2, band_w // 2 + 1,
                                             NB), 0, lt).astype(np.int32)
    return pats, plens, texts, tlens, quals


def _runs(rops, rlens, r):
    return [(int(o), int(n)) for o, n in zip(np.asarray(rops[r]),
                                             np.asarray(rlens[r])) if n > 0]


@pytest.mark.parametrize("atype", ATYPES, ids=IDS)
@pytest.mark.parametrize("lp,band_w", [(640, 31), (1300, 15), (600, 63)])
def test_k4_plain_matches_jax_k4(lp, band_w, atype):
    arrays = _long_batch(lp, band_w, lp + band_w, atype)
    t_args = [torch.from_numpy(a) for a in arrays]
    j_args = [jnp.asarray(a) for a in arrays]
    scheme = SCHEMES[atype]
    kw = dict(scheme=scheme, atype=atype, band_w=band_w)
    jkw = dict(scheme=JScheme(**scheme.__dict__), atype=JAType(atype.value),
               band_w=band_w, interpret=True, tile=128)

    got = long_dp.banded_score_long(*t_args, **kw)
    want = banded_score_long_pallas(*j_args, **jkw)
    res, dirs = long_dp.banded_directions_long(*t_args, **kw)
    res_j, dirs_j, stride_j = banded_directions_long_pallas(*j_args, **jkw)
    score = np.asarray(want["score"])
    ok = score > -(1 << 29)  # the sink is defined only where a path is
    assert ok.sum() >= NB - 2
    for r in (got, res):
        for k in ("score", "p_end", "t_end"):
            np.testing.assert_array_equal(r[k].numpy()[ok],
                                          np.asarray(want[k])[ok], k)
            np.testing.assert_array_equal(r[k].numpy()[ok],
                                          np.asarray(res_j[k])[ok], k)
        np.testing.assert_array_equal(r["score"].numpy(), score)

    i0 = res["p_end"].long()
    k0 = res["t_end"].long() - i0 + band_w
    walk = torch_walk(dirs.reshape(NB, -1), 2 * band_w + 1, i0, k0,
                      active=torch.from_numpy(ok))
    ji0 = res_j["p_end"].astype(jnp.int32)
    jk0 = res_j["t_end"].astype(jnp.int32) - ji0 + band_w
    walk_j = jax_runjump_walk(dirs_j, int(stride_j), ji0, jk0,
                              active=jnp.asarray(ok))
    for r in np.flatnonzero(ok):
        assert _runs(walk[2], walk[3], r) == _runs(walk_j[2], walk_j[3], r)
        assert int(walk[0][r]) == int(walk_j[0][r])
        assert int(walk[1][r]) == int(walk_j[1][r])
    assert sum(len(_runs(walk[2], walk[3], r)) for r in np.flatnonzero(ok)
               ) > 2 * ok.sum()  # the walks cross gaps


@pytest.mark.parametrize("atype", ATYPES, ids=IDS)
@pytest.mark.parametrize("band_w", [100, 300])
def test_k4_plain_matches_jax_k4_past_128_cells(band_w, atype):
    """The plain version at bands past 128 cells, the shapes K4's column
    sweep and block tiers take on CUDA (Lp 520 at band_w 100 and 300, 4
    lanes), against the JAX K4 score in interpret mode: every output
    equal, scores below the floor included."""
    arrays = [a[:4] for a in _long_batch(520, band_w, band_w + 7, atype)]
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    got = long_dp.banded_score_long(*[torch.from_numpy(a) for a in arrays],
                                    **kw)
    want = banded_score_long_pallas(
        *[jnp.asarray(a) for a in arrays], scheme=JScheme(
            **SCHEMES[atype].__dict__), atype=JAType(atype.value),
        band_w=band_w, interpret=True, tile=128)
    assert (np.asarray(want["score"]) > -(1 << 29)).sum() >= 3
    for k in ("score", "p_end", "t_end"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      k)


#: (Lp, band_w) -> K4's score tier, rows a lane and warps a block
#: (``long_dp.wide_plan``); tests/test_torch_cuda.py holds the C entry
#: ``k4_wide_plan`` equal to the Python plan over every Lp and band_w
#: named here
_SWEEP4, _SWEEP8 = (long_dp.SWEEP, 4, 8), (long_dp.SWEEP, 8, 8)
_BLOCK, _GROUP = (long_dp.BLOCK, 0, 0), (long_dp.GROUP, 0, 0)
WIDE_PLAN_TABLE = {
    (1, 64): _SWEEP4, (128, 64): _SWEEP4, (128, 530): _SWEEP4,
    (128, 1023): _SWEEP4, (129, 64): _SWEEP8, (160, 530): _SWEEP8,
    (256, 971): _SWEEP8, (257, 64): _BLOCK, (257, 128): _BLOCK,
    (512, 530): _BLOCK, (1025, 512): _BLOCK, (2016, 530): _BLOCK,
    (2049, 971): _BLOCK, (10_000, 100): _BLOCK, (128, 63): _GROUP,
    (600, 0): _GROUP, (2016, 63): _GROUP}


def test_wide_plan_table():
    """K4's score tiers by shape (``long_dp.wide_plan``, mirrored by the
    C entry ``k4_wide_plan``, which the CUDA tests hold equal): the group
    kernel to 128 cells; past them the column sweep on one warp an
    alignment (8 a block) at 4 rows a lane to Lp 128 and 8 to 256 (the PE
    --local rescue on 100 and 150 bp mates), else the block kernel (for
    symbol and packed windows alike); ValueError past 2 048 cells."""
    for (lp, band_w), want in WIDE_PLAN_TABLE.items():
        assert long_dp.wide_plan(lp, band_w) == want, (lp, band_w)
    for band_w in (-1, 1024, 5000):
        with pytest.raises(ValueError, match="2048 cells"):
            long_dp.wide_plan(128, band_w)


def test_route_table():
    """The kernel a call launches on CUDA, by pattern length and band:
    K4 past LONG_THRESHOLD rows or past K1-K3's 64-cell band."""
    for lp in (1, 128, banded_dp.LONG_THRESHOLD):
        for band_w in (0, 15, 31):
            assert banded_dp.route(lp, band_w, False) == "K1"
            assert banded_dp.route(lp, band_w, False, packed=True) == "K3"
            assert banded_dp.route(lp, band_w, True) == "K2"
        for band_w in (32, 63, 500):
            for dirs, packed in ((False, False), (False, True), (True, False)):
                assert banded_dp.route(lp, band_w, dirs, packed) == "K4"
    for lp in (banded_dp.LONG_THRESHOLD + 1, 2016):
        for band_w in (0, 15, 31, 63):
            for dirs, packed in ((False, False), (False, True), (True, False)):
                assert banded_dp.route(lp, band_w, dirs, packed) == "K4"


def test_band_reach_matches_jax():
    """Score-only is served where the JAX package serves it with K4 (not
    K5), directions where its row-block shrink makes them fit."""
    for band_w in range(1, 1001):
        assert long_dp.score_reach(band_w) == _band_fits(band_w, 256, False)
        row_block = 256
        while row_block > 8 and not _band_fits(band_w, row_block, True):
            row_block //= 2
        assert long_dp.dirs_reach(band_w) == _band_fits(band_w, row_block,
                                                        True), band_w
    assert max(b for b in range(1, 1001) if long_dp.score_reach(b)) == 971
    assert max(b for b in range(1, 1001) if long_dp.dirs_reach(b)) == 815


def test_beyond_reach_raises_like_jax(monkeypatch):
    """Score-only beyond K4's reach dispatches to K5 (band 972, as
    ``banded_score_long_pallas`` does); directions beyond 815 raise."""
    lp = 600
    pats = torch.zeros((1, lp), dtype=torch.int8)
    plens = torch.full((1,), lp, dtype=torch.int32)
    kw = dict(scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL)

    def texts(band_w):
        return torch.zeros((1, lp + 2 * band_w), dtype=torch.int8)

    calls = []
    monkeypatch.setattr(long_dp.wavefront_dp, "wavefront_score",
                        lambda *a, **k: calls.append(k["band_w"]) or "K5")
    assert banded_dp.banded_score(pats, plens, texts(971), plens, band_w=971,
                                  **kw) != "K5"
    assert calls == []
    assert banded_dp.banded_score(pats, plens, texts(972), plens, band_w=972,
                                  **kw) == "K5"
    assert calls == [972]
    assert not _band_fits(972, 256, with_dirs=False)
    with pytest.raises(ValueError, match="815"):
        banded_dp.banded_directions(pats, plens, texts(816), plens,
                                    band_w=816, **kw)
    jp = [jnp.asarray(a.numpy()) for a in (pats, plens, texts(816), plens)]
    with pytest.raises(ValueError):  # the JAX package's own refusal
        banded_directions_long_pallas(
            *jp, scheme=JScheme(), atype=JAType.SEMI_GLOBAL, band_w=816,
            interpret=True)


def test_check_long_guard():
    """The sentinel-floor guard of nvbio_tpu/ops/long_dp.py:391, as a
    ValueError: default penalties reach ~87 kb."""
    for lp, band_w in ((80_000, 63), (2016, 971)):
        long_dp.check_long(lp, band_w, GotohScheme())
        _check_long(lp, band_w, JScheme())
    with pytest.raises(ValueError, match="sentinel floor"):
        long_dp.check_long(90_000, 63, GotohScheme())
    with pytest.raises(AssertionError):
        _check_long(90_000, 63, JScheme())
    pats = torch.zeros((1, 90_000), dtype=torch.int8)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="sentinel floor"):
        banded_dp.banded_score(pats, lens, torch.zeros((1, 90_126),
                                                       dtype=torch.int8),
                               lens, scheme=GotohScheme(),
                               atype=AlignmentType.SEMI_GLOBAL, band_w=63)
