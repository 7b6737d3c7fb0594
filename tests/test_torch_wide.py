"""The two-pass wide-band CIGAR in the port (``alignment/wide.py`` on CPU
tensors: K5's and K4's plain versions, the run-jump walk, K5's flags and
the device walk for pass 3) against the JAX package's
``wide_band_cigar_batch(use_pallas=True, interpret=True)``, on
tests/test_wide_cigar.py's Pallas case (Lp 600, band_w 900) and its
forced-gap case (an 850 bp deletion whose certificate exceeds the 767
ladder, so pass 3 runs).  Every output array is compared exactly; the
run arrays after dropping all-zero trailing columns (their width follows
each package's flag stride).  Also ``sw_benchmark --device cpu --long``
at a tiny size."""

import json

import numpy as np
import pytest
import torch

from nvbio_tpu.alignment.types import (AlignmentType as JAType,
                                       GotohScheme as JScheme)
from nvbio_tpu.alignment.wide import (derive_tb_band as jax_derive,
                                      wide_band_cigar_batch as jax_wide)
from nvbio_tpu_torch.alignment import wide
from nvbio_tpu_torch.alignment.types import (AlignmentType, GotohScheme,
                                             gap_penalties)
from nvbio_tpu_torch.ops import banded_dp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the plain DP runs ~30 small ops per
    pattern row, which slow down many times over when the test workers'
    thread pools fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mutate(rng, seq, n_sub, n_indel, max_gap=40):
    """tests/test_wide_cigar.py's mutator: substitutions and long indels."""
    s = list(seq)
    for _ in range(n_indel):
        p = int(rng.integers(1, max(len(s) - 1, 2)))
        glen = int(rng.integers(1, max_gap + 1))
        if rng.random() < 0.5:
            s[p:p] = list(rng.integers(0, 4, glen))
        else:
            del s[p:p + glen]
    for _ in range(n_sub):
        p = int(rng.integers(0, len(s)))
        s[p] = int(rng.integers(0, 4))
    return np.array(s, np.int8)


def _wide_batch(rng, nb, lp, band_w, n_sub, n_indel):
    """tests/test_wide_cigar.py's batch: reads planted at random offsets
    in a wide text window."""
    lt = lp + 2 * band_w
    pats = np.full((nb, lp), 7, np.int8)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    plens = np.full(nb, lp, np.int32)
    tlens = np.full(nb, lt, np.int32)
    for b in range(nb):
        p = rng.integers(0, 4, lp).astype(np.int8)
        pats[b] = p
        t = _mutate(rng, p, n_sub, n_indel)
        off = int(rng.integers(0, band_w - 100))
        texts[b, off:off + len(t)] = t[:lt - off]
    quals = rng.integers(15, 41, (nb, lp)).astype(np.int32)
    return pats, plens, texts, tlens, quals


def _trim(a):
    nz = np.flatnonzero(np.asarray(a).any(axis=0))
    return np.asarray(a)[:, :nz[-1] + 1 if nz.size else 0]


def _compare(pats, plens, texts, tlens, quals, scheme, band_w):
    kw = dict(atype=AlignmentType.SEMI_GLOBAL, band_w=band_w)
    want = jax_wide(pats, plens, texts, tlens, quals,
                    scheme=JScheme(**scheme.__dict__),
                    atype=JAType.SEMI_GLOBAL, band_w=band_w,
                    use_pallas=True, interpret=True)
    got = wide.wide_band_cigar_batch(
        *[torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)],
        scheme=scheme, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k in ("run_ops", "run_lens"):
            g, w = _trim(g), _trim(w)
        np.testing.assert_array_equal(g, w, err_msg=k)
    return got


def _rescore(out, r, pats, texts, quals, scheme):
    """tests/test_wide_cigar.py's re-scoring of the emitted runs."""
    eo, ee, fo, fe = gap_penalties(scheme)
    runs = [(int(o), int(l)) for o, l in zip(out["run_ops"][r],
                                             out["run_lens"][r]) if l > 0]
    i, j = int(out["p_start"][r]), int(out["t_start"][r])
    score = 0
    for op, ln in runs[::-1]:
        if op == 1:
            for _ in range(ln):
                score += scheme.substitution(int(pats[r, i]), int(texts[r, j]),
                                             int(quals[r, i]))
                i += 1
                j += 1
        elif op == 2:
            score -= eo + ln * ee
            j += ln
        elif op == 3:
            score -= fo + ln * fe
            i += ln
    return score, i, j


def test_wide_cigar_matches_jax_pallas_interpret():
    rng = np.random.default_rng(7)
    lp, band_w = 600, 900
    pats, plens, texts, tlens, quals = _wide_batch(rng, 2, lp, band_w,
                                                   n_sub=25, n_indel=5)
    out = _compare(pats, plens, texts, tlens, quals, GotohScheme(), band_w)
    assert out["tb_ok"].all()
    for r in range(2):
        s, i, j = _rescore(out, r, pats, texts, quals, GotohScheme())
        assert (s, i, j) == (out["score"][r], out["p_end"][r],
                             out["t_end"][r])


def test_wide_cigar_pass3_matches_jax():
    """tests/test_wide_cigar.py's forced 850 bp deletion: the certificate
    passes the ladder, pass 3 walks K5's flags."""
    rng = np.random.default_rng(21)
    scheme = GotohScheme(match=2, mismatch_min=6, mismatch_max=6,
                         gap_open=50, gap_extend=1,
                         ref_gap_open=30, ref_gap_extend=10)
    lp, band_w, gap = 400, 1000, 850
    a = rng.integers(0, 4, 200).astype(np.int8)
    b = rng.integers(0, 4, 200).astype(np.int8)
    pats = np.concatenate([a, b])[None, :]
    lt = lp + 2 * band_w
    text = np.concatenate([a, rng.integers(0, 4, gap).astype(np.int8),
                           b, rng.integers(0, 4, lt).astype(np.int8)])
    texts = text[None, :lt]
    plens = np.full(1, lp, np.int32)
    tlens = np.full(1, lt, np.int32)
    quals = np.full((1, lp), 35, np.int32)
    out = _compare(pats, plens, texts, tlens, quals, scheme, band_w)
    need, _ = wide.derive_tb_band(plens, out["score"], out["p_end"],
                                  out["t_end"], scheme, band_w)
    assert need[0] > wide.TB_BANDS[-1] and out["tb_ok"][0]
    runs = [(int(o), int(l)) for o, l in zip(out["run_ops"][0],
                                             out["run_lens"][0]) if l > 0]
    assert (2, gap) in runs


def test_derive_tb_band_matches_jax():
    rng = np.random.default_rng(4)
    n = 64
    args = (rng.integers(100, 5000, n), rng.integers(-9000, 5000, n),
            rng.integers(0, 5000, n), rng.integers(0, 9000, n))
    for scheme in (GotohScheme(), GotohScheme(gap_extend=0,
                                              ref_gap_extend=0)):
        got = wide.derive_tb_band(*args, scheme, 2000)
        want = jax_derive(*args, JScheme(**scheme.__dict__), 2000)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_sw_benchmark_cpu_long(capsys):
    """``sw_benchmark --device cpu --long`` at a tiny size prints the JAX
    tool's CPU rows, through the plain versions; ``--device cuda`` raises
    without a card."""
    from nvbio_tpu_torch.tools.sw_benchmark import main

    banded_dp.reset_launch_counts()
    assert main(["--device", "cpu", "--long", "--batch", "64", "--iters",
                 "1", "--long-len", "600", "--wide-band", "900"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(r["aligner"], r["engine"]) for r in rows] == [
        ("edit_distance", "torch"), ("gotoh_semi_global", "torch"),
        ("gotoh_local", "torch"), ("gotoh_global", "torch"),
        ("myers_edit_distance", "torch"), ("gotoh_long_600", "torch"),
        ("wide_cigar_900", "torch")]
    assert rows[-1]["cigars"] == 2
    assert all(f.launches == 0 for f in banded_dp.KERNELS.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--device", "cuda", "--long"])
