"""K5 in the port (``ops/wavefront_dp.py`` on CPU tensors, i.e. its plain
versions) against the JAX package's K5 (``wavefront_score_pallas`` and
``wavefront_dirs_pallas`` in interpret mode, as tests/test_wavefront.py
runs them) and its twin (``banded_score_batch``); the port's walks over
its flags against the JAX device walk over the JAX kernel's flags; and
``banded_score_long`` beyond K4's reach against
``banded_score_long_pallas``.  Tolerance: exact, every output is an
integer.  The CUDA kernel is held against the same plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alignment.batched import banded_score_batch as jax_twin
from nvbio_tpu.alignment.types import (AlignmentType as JAType,
                                       GotohScheme as JScheme)
from nvbio_tpu.alignment.wavefront_walk import (
    walk_wavefront_dirs_device as jax_walk_device)
from nvbio_tpu.ops.long_dp import banded_score_long_pallas
from nvbio_tpu.ops.wavefront_dp import (wavefront_dirs_pallas,
                                        wavefront_score_pallas)
from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
from nvbio_tpu_torch.alignment.wavefront_walk import (
    compress_ops, walk_wavefront_dirs, walk_wavefront_dirs_device)
from nvbio_tpu_torch.ops import banded_dp, long_dp, wavefront_dp

FIELDS = ("score", "p_end", "t_end")
ATYPES = list(AlignmentType)
IDS = [a.name.lower() for a in ATYPES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the plain DP runs ~30 small ops per
    pattern row, which slow down many times over when the test workers'
    thread pools fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_kw(atype, band_w, scheme=None):
    s = scheme or GotohScheme()
    return dict(scheme=JScheme(**s.__dict__), atype=JAType[atype.name],
                band_w=band_w)


def _port(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _assert_fields(got, want, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f"{msg} {f}")


def _random_batch(rng):
    """tests/test_wavefront.py's randomized case: N symbols, ragged and
    zero lengths, quality-scaled mismatches."""
    nb = 3
    lp = int(rng.integers(5, 90))
    lt = int(rng.integers(5, 120))
    bw = int(rng.integers(3, 40))
    pats = rng.integers(0, 5, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 5, (nb, lt)).astype(np.int32)
    plens = rng.integers(0, lp + 1, nb).astype(np.int32)
    tlens = rng.integers(0, lt + 1, nb).astype(np.int32)
    quals = rng.integers(0, 41, (nb, lp)).astype(np.int32)
    return (pats, plens, texts, tlens, quals), bw


def _check_score(arrays, atype, band_w, scheme=None):
    jp = [None if a is None else jnp.asarray(a) for a in arrays]
    kw = _jax_kw(atype, band_w, scheme)
    want = wavefront_score_pallas(*jp, interpret=True, **kw)
    twin = jax_twin(*jp, **kw)
    got = wavefront_dp.wavefront_score(
        *_port(arrays), scheme=scheme or GotohScheme(), atype=atype,
        band_w=band_w)
    _assert_fields(got, want, f"{atype} vs K5")
    _assert_fields(got, twin, f"{atype} vs twin")


@pytest.mark.parametrize("atype", ATYPES, ids=IDS)
def test_wavefront_plain_matches_jax_random(atype):
    rng = np.random.default_rng(1234)
    for _ in range(4):
        arrays, bw = _random_batch(rng)
        _check_score(arrays, atype, bw)


@pytest.mark.parametrize("atype", ATYPES, ids=IDS)
def test_wavefront_plain_matches_jax_wide_rebase(atype):
    """tests/test_wavefront.py's wide-band case (several window rebases
    in the JAX kernel), with a GLOBAL goal outside the band on lane 1."""
    rng = np.random.default_rng(7)
    nb, lp, bw = 2, 1200, 520
    lt = lp + 180
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int32)
    texts[:, 90:90 + lp] = pats
    for b in range(nb):
        mut = rng.integers(0, lt, 90)
        texts[b, mut] = rng.integers(0, 4, 90)
    plens = np.array([lp, lp - 37], np.int32)
    tlens = np.array([lt, 100], np.int32)  # lane 1: goal far below the band
    _check_score((pats, plens, texts, tlens, None), atype, bw)


@pytest.mark.parametrize("atype", ATYPES, ids=IDS)
def test_wavefront_plain_matches_jax_band_sweep_edges(atype):
    """tests/_k5_band_cases' lanes at band_w 260, Lp 520 (two strips of
    the CUDA banded tier and one lane's 8 rows): ties from a periodic
    pattern in a periodic text, plen 256, 257 and 520, tlen below the last
    strip's band and GLOBAL goals clipped to either band edge, N symbols
    and qualities 0-41.  The card holds the tier to the plain version on
    the same lanes (tests/test_torch_cuda.py)."""
    import _k5_band_cases as k5_cases

    pats, plens, texts, tlens, quals = k5_cases.batch(520, 260, 800)
    _check_score((pats, plens, texts, tlens, quals.astype(np.int32)), atype,
                 260)


def test_wavefront_plain_matches_jax_scheme():
    """A non-default scheme (tests/test_wavefront.py's), LOCAL and
    SEMI_GLOBAL."""
    rng = np.random.default_rng(11)
    nb, lp, lt, bw = 3, 200, 260, 48
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int32)
    texts[:, 20:20 + lp] = pats
    plens = np.full(nb, lp, np.int32)
    tlens = np.full(nb, lt, np.int32)
    quals = rng.integers(0, 41, (nb, lp)).astype(np.int32)
    scheme = GotohScheme(match=2, mismatch_min=3, mismatch_max=9,
                         n_penalty=2, gap_open=7, gap_extend=2)
    for atype in (AlignmentType.LOCAL, AlignmentType.SEMI_GLOBAL):
        _check_score((pats, plens, texts, tlens, quals), atype, bw, scheme)


def _walk_batch():
    """test_device_walk_matches_host_walk's lanes (W 96, Lp 256): a big
    deletion, a big insertion, substitutions only."""
    rng = np.random.default_rng(88)
    W, LP = 96, 256
    nb = 3
    lt = LP + 2 * W
    pats = rng.integers(0, 4, (nb, LP)).astype(np.int8)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    texts[0, W:W + 120] = pats[0, :120]
    texts[0, W + 120 + 60:W + LP + 60] = pats[0, 120:]
    ins = pats[1].copy()
    ins = np.concatenate([ins[:100], rng.integers(0, 4, 40), ins[100:]])
    texts[1, W:W + len(ins[:LP + 40])] = ins[:min(len(ins), lt - W)]
    t2 = pats[2].copy()
    t2[::17] = (t2[::17] + 1) % 4
    texts[2, W:W + LP] = t2
    return (pats, np.full(nb, LP, np.int32), texts,
            np.full(nb, lt, np.int32)), W


def test_wavefront_walks_match_jax():
    """Port flags + both port walks == JAX K5 flags + JAX device walk:
    op streams, op counts and start cells, per lane."""
    arrays, W = _walk_batch()
    kw = dict(scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
              band_w=W)
    jp = [jnp.asarray(a) for a in arrays]
    jres, jdirs, plan = wavefront_dirs_pallas(*jp, interpret=True,
                                              **_jax_kw(kw["atype"], W))
    jops, jn, jps, jts = (np.asarray(x) for x in jax_walk_device(
        jdirs, jres["p_end"], jres["t_end"], plan=plan, band_w=W))
    res, dirs = wavefront_dp.wavefront_dirs(*_port(arrays), **kw)
    _assert_fields(res, jres, "dirs score")
    ops, n, ps, ts = walk_wavefront_dirs_device(
        dirs, res["p_end"], res["t_end"], band_w=W, lp=arrays[0].shape[1],
        lt=arrays[2].shape[1])
    np.testing.assert_array_equal(n.numpy(), jn)
    np.testing.assert_array_equal(ps.numpy(), jps)
    np.testing.assert_array_equal(ts.numpy(), jts)
    for b in range(len(n)):
        np.testing.assert_array_equal(ops[b, :n[b]].numpy(),
                                      jops[b, :jn[b]], err_msg=f"lane {b}")
        ro, rl, hps, hts = walk_wavefront_dirs(dirs[b].numpy(), W,
                                               int(res["p_end"][b]),
                                               int(res["t_end"][b]))
        ro2, rl2 = compress_ops(jops[b, :jn[b]])
        np.testing.assert_array_equal(ro, ro2)
        np.testing.assert_array_equal(rl, rl2)
        assert (hps, hts) == (int(jps[b]), int(jts[b]))
    assert 2 in ops[0].numpy() and 3 in ops[1].numpy()  # planted indels


def _sweep_words(twin, band_w):
    """The twin's flags (NB, Lp, 2w+1) placed cell by cell into the sweep
    layout (NB, S, T, 32) as uint32 words, 3 in every nibble of a slot
    that holds no twin cell; asserts that every twin cell of a column j
    >= 0 has a slot (those left of column 0 hold 3 in the twin)."""
    nb, lp, band = twin.shape
    n_strips, n_steps = wavefront_dp.flag_shape(lp, band_w)
    assert (n_strips, n_steps) == (-(-lp // 256), 256 + 2 * band_w + 32)
    words = np.full((nb, n_strips, n_steps, 32), 0x33333333, np.uint64)
    for r in range(1, lp + 1):
        p, lane, i = (r - 1) // 256, (r - 1) % 256 // 8, (r - 1) % 8
        jbase = max(0, 256 * p + 1 - band_w) - 1
        for k in range(band):
            s = r + k - band_w - jbase + lane  # column j = r + k - w
            if s < 0 and r + k - band_w < 0:
                assert (twin[:, r - 1, k] == 3).all(), (r, k)
                continue
            assert 0 <= s < n_steps, (r, k)
            nib = twin[:, r - 1, k].astype(np.uint64)
            w = words[:, p, s, lane]
            words[:, p, s, lane] = (w & ~np.uint64(15 << (4 * i))) | (
                nib << np.uint64(4 * i))
    return words.astype(np.uint32)


def _assert_sweep_flags(dirs, twin, band_w):
    want = _sweep_words(twin.numpy(), band_w)
    assert dirs.dtype == torch.int32 and dirs.shape == want.shape
    np.testing.assert_array_equal(dirs.numpy().view(np.uint32), want)


@pytest.mark.parametrize("atype", ATYPES, ids=IDS)
def test_wavefront_flags_equal_twin_flags(atype):
    """The flag layout round trip: every word of the plain flags (NB, S,
    T, 32) holds the twin's flags of its 8 cells, 3 wherever the twin has
    no cell."""
    rng = np.random.default_rng(5)
    arrays, bw = _random_batch(rng)
    from nvbio_tpu_torch.alignment.batched import banded_directions_batch

    port = _port(arrays)
    kw = dict(scheme=GotohScheme(), atype=atype, band_w=bw)
    _, dirs = wavefront_dp.wavefront_dirs(*port, **kw)
    _, twin = banded_directions_batch(*port, twin=True, **kw)
    _assert_sweep_flags(dirs, twin, bw)


@pytest.mark.parametrize("lp", [255, 256, 257])
@pytest.mark.parametrize("atype", ATYPES, ids=IDS)
def test_wavefront_sweep_flags_strip_edges(atype, lp):
    """At a strip edge of the sweep layout (Lp 255 / 256 / 257), on
    tests/_k5_band_cases' lanes and two with plen < Lp (one into the last
    lane's 8 rows, one 13 rows short): the plain flags are the twin's cell
    for cell, the result is the JAX kernel's, and both port walks equal
    the JAX device walk over the JAX kernel's flags."""
    import _k5_band_cases as k5_cases

    bw, lt = 24, lp + 60
    pats, plens, texts, tlens, quals = k5_cases.batch(lp, bw, lt, seed=lp)
    take = [0, 1, 2, 3, 3, 3]
    pats, texts, tlens, quals = (x[take] for x in (pats, texts, tlens,
                                                    quals))
    plens = np.concatenate([plens, [lp - 1, lp - 13]]).astype(np.int32)
    arrays = (pats.astype(np.int32), plens, texts.astype(np.int32), tlens,
              quals.astype(np.int32))
    scheme = GotohScheme(match=2 if atype == AlignmentType.LOCAL else 0)
    kw = dict(scheme=scheme, atype=atype, band_w=bw)
    from nvbio_tpu_torch.alignment.batched import banded_directions_batch

    res, dirs = wavefront_dp.wavefront_dirs(*_port(arrays), **kw)
    _, twin = banded_directions_batch(*_port(arrays), twin=True, **kw)
    _assert_sweep_flags(dirs, twin, bw)
    jp = [jnp.asarray(a) for a in arrays]
    jres, jdirs, plan = wavefront_dirs_pallas(*jp, interpret=True,
                                              **_jax_kw(atype, bw, scheme))
    _assert_fields(res, jres, "dirs result")
    jops, jn, jps, jts = (np.asarray(x) for x in jax_walk_device(
        jdirs, jres["p_end"], jres["t_end"], plan=plan, band_w=bw))
    ops, n, ps, ts = walk_wavefront_dirs_device(
        dirs, res["p_end"], res["t_end"], band_w=bw, lp=lp, lt=lt)
    np.testing.assert_array_equal(n.numpy(), jn)
    np.testing.assert_array_equal(ps.numpy(), jps)
    np.testing.assert_array_equal(ts.numpy(), jts)
    for b in range(len(n)):
        np.testing.assert_array_equal(ops[b, :n[b]].numpy(),
                                      jops[b, :jn[b]], err_msg=f"lane {b}")
        ro, rl, hps, hts = walk_wavefront_dirs(dirs[b].numpy(), bw,
                                               int(res["p_end"][b]),
                                               int(res["t_end"][b]))
        np.testing.assert_array_equal(np.repeat(ro, rl), jops[b, :jn[b]])
        assert (hps, hts) == (int(jps[b]), int(jts[b]))


def test_banded_score_long_beyond_reach_matches_jax():
    """tests/test_wavefront.py's dispatch case: band 1100 > 971 goes to
    K5 in both packages, raw twin values."""
    band_w = 1100
    assert not long_dp.score_reach(band_w)
    rng = np.random.default_rng(3)
    nb, lp = 2, 600
    lt = lp + 120
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int32)
    texts[:, 60:60 + lp] = pats
    plens = np.full(nb, lp, np.int32)
    tlens = np.full(nb, lt, np.int32)
    arrays = (pats, plens, texts, tlens)
    for atype in (AlignmentType.SEMI_GLOBAL, AlignmentType.GLOBAL):
        want = banded_score_long_pallas(*map(jnp.asarray, arrays), None,
                                        interpret=True,
                                        **_jax_kw(atype, band_w))
        kw = dict(scheme=GotohScheme(), atype=atype, band_w=band_w)
        got = long_dp.banded_score_long(*_port(arrays), **kw)
        _assert_fields(got, want, atype.name)
        _assert_fields(banded_dp.banded_score(*_port(arrays), **kw), want,
                       atype.name)


def test_wavefront_checks_like_jax():
    """The JAX kernel's asserts as ValueError; packed windows stop at
    K4's reach; launch counters exist and start at zero."""
    with pytest.raises(ValueError, match="sink key"):
        wavefront_dp.check_wavefront(1 << 20, 10, 2000, GotohScheme())
    with pytest.raises(ValueError, match="score range"):
        wavefront_dp.check_wavefront(4000, 8000, 2000,
                                     GotohScheme(mismatch_max=60000))
    wavefront_dp.check_wavefront(4000, 8000, 2000, GotohScheme())
    from nvbio_tpu.ops.wavefront_dp import _plan

    for band_w in (0, 3, 96, 1100, 2000):
        assert wavefront_dp.kmul(band_w) == _plan(400, 800, band_w, None)[-1]
    with pytest.raises(ValueError, match="971"):
        long_dp.check_packed(972)
    banded_dp.reset_launch_counts()
    assert {k: f.launches for k, f in banded_dp.KERNELS.items()} == dict.fromkeys(
        ("K1", "K2", "K3", "K4", "K5", "K5_dirs", "K5_matrix", "K6", "K7"),
        0)
