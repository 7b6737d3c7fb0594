"""K7's plain version (the int16 masked banded Gotoh,
``alignment.batched.banded_score_batch16``) against the JAX K7:
``banded_score_pallas(interpret=True, compute_dtype="int16")``, bit for
bit, with ``i16`` asserted in the JAX call's jaxpr so that the oracle
really ran the int16 body (its guard silently falls back to int32).
Shapes the guard refuses take K1 in both packages.  The CUDA kernel is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alignment.types import AlignmentType as JAType
from nvbio_tpu.alignment.types import GotohScheme as JScheme
from nvbio_tpu.ops.banded_dp import banded_score_pallas
from nvbio_tpu_torch.alignment.batched import (banded_score_batch,
                                               banded_score_batch16)
from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
from nvbio_tpu_torch.ops import banded_dp

NB = 130  # not a multiple of the JAX tile, odd pairs of lanes on the card
SCHEMES = {
    AlignmentType.GLOBAL: GotohScheme(),
    AlignmentType.SEMI_GLOBAL: GotohScheme(gap_open=3, gap_extend=1,
                                           ref_gap_open=8, ref_gap_extend=4),
    AlignmentType.LOCAL: GotohScheme(match=2),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, lp, lt, band_w, atype):
    """Patterns copied into their texts with substitutions and N (in both
    operands), ragged lengths, two zero-length patterns, lanes whose
    pattern outruns its text by more than the band (no path), and for
    GLOBAL goal cells in and out of the band."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(5, lp + 1, NB).astype(np.int32)
    tlens = rng.integers(10, lt + 1, NB).astype(np.int32)
    pats = rng.integers(0, 4, (NB, lp)).astype(np.int8)
    quals = rng.integers(0, 42, (NB, lp)).astype(np.uint8)
    texts = rng.integers(0, 4, (NB, lt)).astype(np.int8)
    for b in range(NB):
        n = min(plens[b], tlens[b])
        texts[b, :n] = pats[b, :n]
        for _ in range(rng.integers(0, 4)):
            texts[b, rng.integers(0, tlens[b])] = rng.integers(0, 4)
    pats[rng.random((NB, lp)) < 0.03] = 4
    texts[rng.random((NB, lt)) < 0.03] = 4
    plens[:2] = 0
    plens[2:8] = lp  # unreachable: tlen + band_w < plen
    tlens[2:8] = np.maximum(lp - band_w - 3, 0)
    if atype == AlignmentType.GLOBAL:  # goal cells in and out of the band
        tlens[8:] = np.clip(plens[8:] + rng.integers(
            -2 * band_w, 2 * band_w + 1, NB - 8), 0, lt)
    return pats, plens, texts, tlens, quals


def _jax_k7(arrays, scheme, atype, band_w):
    args = tuple(jnp.asarray(a) for a in arrays)
    kw = dict(scheme=JScheme(**scheme.__dict__), atype=JAType(atype.value),
              band_w=band_w, interpret=True, compute_dtype="int16")
    jaxpr = str(jax.make_jaxpr(lambda *a: banded_score_pallas(*a, **kw))(
        *args))
    return banded_score_pallas(*args, **kw), jaxpr


def _check(arrays, scheme, atype, band_w):
    want, jaxpr = _jax_k7(arrays, scheme, atype, band_w)
    assert "i16" in jaxpr  # the oracle ran the int16 body
    tensors = [torch.from_numpy(a) for a in arrays]
    got = banded_score_batch16(*tensors, scheme=scheme, atype=atype,
                               band_w=band_w)
    wrapped = banded_dp.banded_score(*tensors, scheme=scheme, atype=atype,
                                     band_w=band_w, compute_dtype="int16")
    for k in ("score", "p_end", "t_end"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(wrapped[k].numpy(), got[k].numpy(),
                                      err_msg=k)
    return got


@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_plain_k7_matches_jax_k7(atype):
    lp, band_w = 32, 7
    arrays = _batch(5 + atype.value, lp, 46, band_w, atype)
    scheme = SCHEMES[atype]
    assert banded_dp.int16_ok(lp, band_w, scheme)
    assert banded_dp.route(lp, band_w, False, compute_dtype="int16",
                           scheme=scheme) == "K7"
    got = _check(arrays, scheme, atype, band_w)
    score = got["score"].numpy()
    k1 = banded_score_batch(*(torch.from_numpy(a) for a in arrays),
                            scheme=scheme, atype=atype, band_w=band_w)
    if atype == AlignmentType.LOCAL:
        assert (score[:2] == 0).all() and (score > 0).mean() > 0.5
        return
    assert (score[:8] == -(1 << 30)).all()  # zero-length and unreachable
    assert (score > -(1 << 29)).mean() > 0.4
    if atype == AlignmentType.SEMI_GLOBAL:
        # K7's own contract: an unreachable lane's t_end is plen - w
        np.testing.assert_array_equal(got["t_end"].numpy()[2:8],
                                      arrays[1][2:8] - band_w)
    else:  # out-of-band goals are no path, in-band goals K1's values
        k_goal = arrays[3] - arrays[1] + band_w
        out = (k_goal < 0) | (k_goal > 2 * band_w)
        assert out[8:].sum() > 10 and (score[8:][out[8:]] == -(1 << 30)).all()
        np.testing.assert_array_equal(score[8:][~out[8:]],
                                      k1["score"].numpy()[8:][~out[8:]])


@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_plain_k7_wide_band_matches_jax_k7(atype):
    """A band of 241 cells at Lp 16, inside the guard (on the card 137
    of them live, the group kernel's 256-cell tier)."""
    lp, band_w = 16, 120
    scheme = SCHEMES[atype]
    assert banded_dp.int16_ok(lp, band_w, scheme)
    _check(_batch(11 + atype.value, lp, 300, band_w, atype), scheme, atype,
           band_w)


@pytest.mark.parametrize("lp", [20, 100])
def test_guarded_out_shapes_take_k1(lp):
    """Lp8 = 24 or 104 is no multiple of 16: the JAX package runs its
    int32 body (K1) for compute_dtype="int16", and so does the port, with
    K1's contract (tests/test_torch_banded_dp.py): equal scores, and
    equal sinks wherever a path exists."""
    band_w = 7
    atype, scheme = AlignmentType.SEMI_GLOBAL, GotohScheme()
    assert not banded_dp.int16_ok(lp, band_w, scheme)
    assert banded_dp.route(lp, band_w, False, compute_dtype="int16",
                           scheme=scheme) == "K1"
    arrays = _batch(3, lp, lp + 14, band_w, atype)
    want, jaxpr = _jax_k7(arrays, scheme, atype, band_w)
    assert "i16" not in jaxpr
    got = banded_dp.banded_score(*(torch.from_numpy(a) for a in arrays),
                                 scheme=scheme, atype=atype, band_w=band_w,
                                 compute_dtype="int16")
    score = np.asarray(want["score"])
    np.testing.assert_array_equal(got["score"].numpy(), score)
    ok = score > -(1 << 29)
    assert ok.mean() > 0.4
    for k in ("p_end", "t_end"):
        np.testing.assert_array_equal(got[k].numpy()[ok],
                                      np.asarray(want[k])[ok], err_msg=k)
    with pytest.raises(ValueError, match="int16 guard"):
        banded_dp.banded_score16(*(torch.from_numpy(a) for a in arrays),
                                 scheme=scheme, atype=atype, band_w=band_w)


def test_guard_and_route_table():
    s = GotohScheme()
    # the widest band the guard admits at Lp8 = 16, and one cell more
    assert banded_dp.int16_ok(16, 719, s)
    assert not banded_dp.int16_ok(16, 720, s)
    assert not banded_dp.int16_ok(128, 15, GotohScheme(mismatch_max=60))
    assert banded_dp.int16_ok(128, 15, s)  # chip_smoke's K1-row shape
    assert banded_dp.route(128, 63, False, compute_dtype="int16",
                           scheme=s) == "K7"
    assert banded_dp.route(128, 63, False) == "K4"
    assert banded_dp.route(128, 63, False, compute_dtype="int32",
                           scheme=s) == "K4"
    # the guard is applied by route() itself: Lp8 = 104 takes K1
    assert banded_dp.route(100, 7, False, compute_dtype="int16",
                           scheme=s) == "K1"
    assert banded_dp.route(600, 7, False, compute_dtype="int16",
                           scheme=s) == "K4"
    with pytest.raises(ValueError, match="compute_dtype"):
        banded_dp.banded_score(*(torch.zeros((1, 16), dtype=torch.int8),
                                 torch.zeros(1, dtype=torch.int32)) * 2,
                               scheme=s, atype=AlignmentType.GLOBAL,
                               band_w=3, compute_dtype="float16")
