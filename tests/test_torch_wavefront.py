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
    ops, n, ps, ts = walk_wavefront_dirs_device(dirs, res["p_end"],
                                                res["t_end"], band_w=W)
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


@pytest.mark.parametrize("atype", ATYPES, ids=IDS)
def test_wavefront_flags_equal_twin_flags(atype):
    """The flag layout round trip: the plain flags are the twin's flags
    moved to diagonals, 3 wherever the twin has no cell."""
    rng = np.random.default_rng(5)
    arrays, bw = _random_batch(rng)
    from nvbio_tpu_torch.alignment.batched import banded_directions_batch

    port = _port(arrays)
    kw = dict(scheme=GotohScheme(), atype=atype, band_w=bw)
    _, dirs = wavefront_dp.wavefront_dirs(*port, **kw)
    _, twin = banded_directions_batch(*port, **kw)
    nb, lp, band = twin.shape
    ndiag, db = wavefront_dp.flag_shape(lp, arrays[2].shape[1], bw)
    assert dirs.shape == (nb, ndiag, db)
    for d in range(ndiag):
        for q in range(2 * db):  # slot q of diagonal d is row r, column j
            r = q - (bw - d) // 2
            j, k = d - r, d - 2 * r + bw
            nib = (dirs[:, d, q >> 1].to(torch.int32) >> (4 * (q & 1))) & 15
            if q <= bw and 1 <= r <= lp and 0 <= k < band:
                want = twin[:, r - 1, k].to(torch.int32)
            else:
                want = torch.full((nb,), 3, dtype=torch.int32)
            assert torch.equal(nib, want), (r, j)


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
