"""Port's plain banded DP (the CUDA kernels' reference versions) against
the JAX twin and the JAX Pallas kernels in interpret mode — exact
equality (all outputs are integers).  The CUDA kernels themselves are
held against these plain versions on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvbio_tpu.alignment.batched import (
    banded_directions_batch as jax_directions,
    banded_score_batch as jax_score,
)
from nvbio_tpu.alignment.types import (
    AlignmentType as JAType,
    GotohScheme as JScheme,
)
from nvbio_tpu.ops.banded_dp import (
    banded_directions_pallas,
    banded_score_pallas,
    banded_score_pallas_packed,
    pack_genome_words as jax_pack_genome_words,
)
from nvbio_tpu_torch.alignment.batched import (
    banded_directions_batch,
    banded_score_batch,
)
from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
from nvbio_tpu_torch.ops import banded_dp

BAND_W = 7
LP, LT = 20, 28
NB = 130  # not a multiple of any tile

CASES = [
    (GotohScheme(), AlignmentType.SEMI_GLOBAL),
    (GotohScheme(match=2), AlignmentType.LOCAL),
    (GotohScheme(), AlignmentType.GLOBAL),
    # asymmetric --rdg/--rfg penalties (read gaps != ref gaps)
    (GotohScheme(gap_open=3, gap_extend=1, ref_gap_open=8,
                 ref_gap_extend=4), AlignmentType.SEMI_GLOBAL),
]
CASE_IDS = ["semi_global", "local", "global", "asym_gaps"]


def _jax_kw(scheme, atype):
    return dict(scheme=JScheme(**scheme.__dict__),
                atype=JAType(atype.value), band_w=BAND_W)


def _random_batch(seed, atype):
    rng = np.random.default_rng(seed)
    plens = rng.integers(5, LP + 1, NB).astype(np.int32)
    tlens = rng.integers(10, LT + 1, NB).astype(np.int32)
    pats = rng.integers(0, 4, (NB, LP)).astype(np.int8)
    quals = rng.integers(0, 42, (NB, LP)).astype(np.uint8)
    texts = rng.integers(0, 4, (NB, LT)).astype(np.int8)
    for b in range(NB):
        n = min(plens[b], tlens[b])
        texts[b, :n] = pats[b, :n]
        for _ in range(rng.integers(0, 4)):
            texts[b, rng.integers(0, tlens[b])] = rng.integers(0, 4)
    pats[rng.random((NB, LP)) < 0.02] = 4  # N in both operands
    texts[rng.random((NB, LT)) < 0.02] = 4
    plens[:2] = 0  # zero-length patterns
    if atype == AlignmentType.GLOBAL:
        # the JAX twin clips an out-of-band GLOBAL goal cell; the
        # kernels' contract reports it as no path
        tlens = np.clip(tlens, plens - BAND_W // 2, plens + BAND_W // 2)
        tlens = np.minimum(tlens, LT).astype(np.int32)
    return pats, plens, quals, texts, tlens


def _np_walk(dirs_flat, stride, p_end, t_end, max_steps=200):
    """Per-step traceback walk over a flag matrix (the automaton of
    tests/test_banded_pallas.py:_np_walk): ops and the start cell."""
    i, k, st = p_end, t_end - p_end + BAND_W, 0
    ops = []
    for _ in range(max_steps):
        if st == 0 and i == 0:
            break
        flag = int(dirs_flat[(i - 1) * stride + k])
        if st == 0:
            if flag & 3 == 3:
                break
            if flag & 3 == 0:
                ops.append("M")
                i -= 1
            else:
                st = flag & 3
        elif st == 1:
            ops.append("D")
            k -= 1
            st = 0 if (flag >> 2) & 1 else 1
        else:
            ops.append("I")
            i, k = i - 1, k + 1
            st = 0 if (flag >> 3) & 1 else 2
        if not 0 <= k < 2 * BAND_W + 1:
            break
    return "".join(ops), i, k


def _assert_res_equal(got, ref, what):
    score = np.asarray(ref["score"])
    np.testing.assert_array_equal(got["score"].numpy(), score, what)
    ok = score > -(1 << 29)  # sink defined only when a path exists
    for k in ("p_end", "t_end"):
        np.testing.assert_array_equal(got[k].numpy()[ok],
                                      np.asarray(ref[k])[ok], f"{what} {k}")


@pytest.mark.parametrize("scheme,atype", CASES, ids=CASE_IDS)
def test_score_matches_jax_twin_and_pallas(scheme, atype):
    pats, plens, quals, texts, tlens = _random_batch(atype.value + 11, atype)
    t_args = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    j_args = [jnp.asarray(a) for a in (pats, plens, texts, tlens, quals)]
    got = banded_score_batch(*t_args, scheme=scheme, atype=atype,
                             band_w=BAND_W)
    kw = _jax_kw(scheme, atype)
    _assert_res_equal(got, jax_score(*j_args, **kw), "vs twin")
    _assert_res_equal(got, banded_score_pallas(*j_args, interpret=True,
                                               **kw), "vs pallas")
    # the wrapper takes the plain version for CPU tensors
    via = banded_dp.banded_score(*t_args, scheme=scheme, atype=atype,
                                 band_w=BAND_W)
    for k in got:
        assert torch.equal(via[k], got[k])


@pytest.mark.parametrize("scheme,atype", CASES, ids=CASE_IDS)
def test_directions_match_jax_twin_and_pallas(scheme, atype):
    pats, plens, quals, texts, tlens = _random_batch(atype.value + 31, atype)
    t_args = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    j_args = [jnp.asarray(a) for a in (pats, plens, texts, tlens, quals)]
    kw = _jax_kw(scheme, atype)
    res, dirs = banded_directions_batch(*t_args, scheme=scheme, atype=atype,
                                        band_w=BAND_W)
    res_x, dirs_x = jax_directions(*j_args, **kw)
    _assert_res_equal(res, res_x, "vs twin")
    # the twin's flags on every cell, valid or not
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_x))
    res_p, dirs_p, stride = banded_directions_pallas(*j_args, interpret=True,
                                                     **kw)
    _assert_res_equal(res, res_p, "vs pallas")
    # the Pallas kernel's H-source bits on every valid in-band cell.  Its
    # gap-open bits differ only where the E/F value is unreachable (the
    # band edges, j = 0: an artefact of its scan's fill), which no walk
    # reads — so the walks from every sink are compared as well
    BAND = 2 * BAND_W + 1
    dp = np.asarray(dirs_p).reshape(NB, -1, stride)[:, :LP, :BAND]
    i = np.arange(LP)[None, :, None]
    k = np.arange(BAND)[None, None, :]
    j = i + 1 + k - BAND_W
    valid = (j >= 0) & (j <= tlens[:, None, None])
    np.testing.assert_array_equal(dirs.numpy()[valid] & 3, dp[valid] & 3)
    score = res["score"].numpy()
    dflat = dirs.numpy().reshape(NB, -1)
    pflat = np.asarray(dirs_p)
    n_walked = 0
    for b in np.flatnonzero((score > -(1 << 29)) & (plens > 0)):
        p_end, t_end = int(res["p_end"][b]), int(res["t_end"][b])
        assert (_np_walk(dflat[b], BAND, p_end, t_end)
                == _np_walk(pflat[b], stride, p_end, t_end)), b
        n_walked += 1
    assert n_walked >= NB // 2
    via_res, via_dirs = banded_dp.banded_directions(
        *t_args, scheme=scheme, atype=atype, band_w=BAND_W)
    assert torch.equal(via_dirs, dirs)


@pytest.mark.parametrize("atype", [AlignmentType.SEMI_GLOBAL,
                                   AlignmentType.LOCAL],
                         ids=["semi_global", "local"])
def test_packed_windows_match_symbol_windows_and_pallas(atype):
    """K3's plain path over pack_genome_words output equals K1's plain
    path over the same windows (genome-end windows included) and the
    Pallas packed kernel in interpret mode."""
    rng = np.random.default_rng(3)
    n, nb, lp, w = 3_000, 70, 24, BAND_W
    lt = lp + 2 * w
    genome = rng.integers(0, 4, n).astype(np.int8)
    ws = rng.integers(0, n - 5, nb).astype(np.int32)
    ws[:4] = [0, n - 1, n - 10, n - lp]
    gpad = np.concatenate([genome, np.full(lt, 7, np.int8)])
    texts = np.stack([gpad[s:s + lt] for s in ws])
    pats = np.zeros((nb, lp), np.int8)
    for b in range(nb):
        seg = genome[ws[b]:ws[b] + lp]
        pats[b, :len(seg)] = seg
        for _ in range(3):
            pats[b, rng.integers(0, lp)] = rng.integers(0, 5)
    plens = rng.integers(lp - 4, lp + 1, nb).astype(np.int32)
    tlens = np.clip(n - ws, 0, lt).astype(np.int32)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    scheme = GotohScheme(match=2) if atype == AlignmentType.LOCAL \
        else GotohScheme()
    kw = dict(scheme=scheme, atype=atype, band_w=w)

    packed = banded_dp.pack_genome_words(genome)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax_pack_genome_words(genome)))
    tp, tpl, tws, ttl, tq = (torch.from_numpy(a)
                             for a in (pats, plens, ws, tlens, quals))
    got = banded_dp.banded_score_packed(tp, tpl, packed, tws, ttl, tq, **kw)
    sym = banded_score_batch(tp, tpl, torch.from_numpy(texts), ttl, tq, **kw)
    for k in got:
        assert torch.equal(got[k], sym[k]), k
    np.testing.assert_array_equal(
        banded_dp.unpack_windows(packed, tws, ttl, lt).numpy()[
            np.arange(lt)[None, :] < tlens[:, None]],
        texts[np.arange(lt)[None, :] < tlens[:, None]])
    ref = banded_score_pallas_packed(
        jnp.asarray(pats), jnp.asarray(plens), jax_pack_genome_words(genome),
        jnp.asarray(ws), jnp.asarray(tlens), jnp.asarray(quals),
        scheme=JScheme(**scheme.__dict__), atype=JAType(atype.value),
        band_w=w, interpret=True)
    _assert_res_equal(got, ref, "vs pallas packed")


def test_packed_windows_serve_any_band_on_cpu():
    """Beyond K4's reach (band_w 1000) the packed path on the CPU still
    serves the call with its plain version, as the JAX mapper on a CPU
    does with its twin over symbol windows."""
    rng = np.random.default_rng(5)
    n, nb, lp, w = 5_000, 6, 24, 1000
    lt = lp + 2 * w
    genome = rng.integers(0, 4, n).astype(np.int8)
    ws = rng.integers(0, n - lt, nb).astype(np.int32)
    ws[0] = n - 300  # a genome-end window
    gpad = np.concatenate([genome, np.full(lt, 7, np.int8)])
    texts = np.stack([gpad[s:s + lt] for s in ws])
    pats = np.stack([gpad[s + w // 2:s + w // 2 + lp] for s in ws])
    pats[rng.random(pats.shape) < 0.1] = 2
    plens = np.full(nb, lp, np.int32)
    tlens = np.clip(n - ws, 0, lt).astype(np.int32)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    atype = AlignmentType.SEMI_GLOBAL
    kw = dict(scheme=GotohScheme(), atype=atype, band_w=w)
    tp, tpl, tws, ttl, tq = (torch.from_numpy(a)
                             for a in (pats, plens, ws, tlens, quals))
    got = banded_dp.banded_score_packed(
        tp, tpl, banded_dp.pack_genome_words(genome), tws, ttl, tq, **kw)
    want = jax_score(*map(jnp.asarray, (pats, plens, texts, tlens, quals)),
                     scheme=JScheme(), atype=JAType(atype.value), band_w=w)
    _assert_res_equal(got, want, "vs twin at band_w 1000")
    assert (got["score"].numpy() > -(1 << 29)).all()


def test_pack_genome_words_rejects_n():
    with pytest.raises(ValueError, match="N/ambiguity"):
        banded_dp.pack_genome_words(np.array([0, 1, 4, 2], np.int8))


def test_wrapper_rejects_mixed_devices_and_wide_bands():
    x = torch.zeros((2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="band"):
        banded_dp._launch_inputs(x, torch.zeros(2), torch.zeros(2), None,
                                 band_w=40)
    with pytest.raises(ValueError, match="device"):
        banded_dp._on_cpu(x, torch.zeros(2, device="meta"))
