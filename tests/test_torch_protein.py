"""Protein support in the port against the JAX package on the same seeded
inputs: the BLOSUM62 tables, the plain twin's matrix gather through
``full_score_batch`` (K5's matrix mode's plain version) and the flag
twin with a matrix, ``hamming_score_batch`` and the GotohScheme
full-matrix path, the wavelet tree's rank and access, the wavelet
FM-index's backward search, and the ``protein_sw`` CLI's TSV.
Tolerance: exact, every output is an integer.  The CUDA kernel is held
against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alignment.batched import (
    banded_directions_batch as jax_dirs_twin)
from nvbio_tpu.alignment.blosum import BLOSUM62 as JAX_BLOSUM62
from nvbio_tpu.alignment.extra import (full_score_batch as jax_full,
                                       hamming_score_batch as jax_hamming)
from nvbio_tpu.alignment.types import (AlignmentType as JAType,
                                       GotohScheme as JScheme)
from nvbio_tpu_torch.alignment.batched import banded_directions_batch
from nvbio_tpu_torch.alignment.blosum import BLOSUM62, MatrixScheme
from nvbio_tpu_torch.alignment.extra import (full_score_batch,
                                             hamming_score_batch)
from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
from nvbio_tpu_torch.ops import wavefront_dp

import _k5_matrix_cases as k5_cases

FIELDS = ("score", "p_end", "t_end")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want, fields=FIELDS):
    for k in fields:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_blosum62_tables_equal():
    np.testing.assert_array_equal(BLOSUM62.matrix_np,
                                  JAX_BLOSUM62.matrix_np)
    assert BLOSUM62.matrix == JAX_BLOSUM62.matrix
    assert (BLOSUM62.gap_open, BLOSUM62.gap_extend) == (
        JAX_BLOSUM62.gap_open, JAX_BLOSUM62.gap_extend)
    assert BLOSUM62.substitution(3, 7) == JAX_BLOSUM62.substitution(3, 7)


def _protein_batch(seed, n, lp, lt, planted=True):
    """Random 20-letter proteins with homologous regions planted in every
    other text (~20 % of the planted residues substituted), ragged
    lengths, and a few X and '*' codes."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(0, 20, (n, lp)).astype(np.int32)
    texts = rng.integers(0, 20, (n, lt)).astype(np.int32)
    plens = rng.integers(lp // 2, lp + 1, n).astype(np.int32)
    tlens = rng.integers(lt // 2, lt + 1, n).astype(np.int32)
    plens[0], tlens[1] = lp, lt
    for i in range(0, n, 2) if planted else ():
        m = int(min(plens[i], tlens[i]))
        s = int(rng.integers(0, tlens[i] - m + 1))
        seg = pats[i, :m].copy()
        sub = rng.random(m) < 0.2
        seg[sub] = rng.integers(0, 20, int(sub.sum()))
        texts[i, s:s + m] = seg
    pats[3, 2] = 20  # X
    texts[5, 1] = 21  # '*'
    return pats, plens, texts, tlens


SHAPES = [(30, 50), (50, 30)]
# planted batches of a shape, then _k5_matrix_cases' kinds (ties, clipped
# symbols, zero lengths) in every alignment type
CASES = [(AlignmentType.LOCAL, s) for s in SHAPES] + [
    (AlignmentType.GLOBAL, (30, 50)), (AlignmentType.SEMI_GLOBAL, (50, 30))
] + [(a, kind) for kind in k5_cases.KINDS for a in AlignmentType]


@pytest.mark.parametrize("atype,case", CASES, ids=[
    f"{a.name.lower()}-" + (c if isinstance(c, str) else f"{c[0]}x{c[1]}")
    for a, c in CASES])
def test_matrix_full_score_equals_jax(atype, case):
    """K5-matrix's plain version (the port's twin with a matrix scheme,
    reached through full_score_batch on CPU tensors) = the JAX twin; the
    same kinds of inputs hold the kernel's full-band tier to the plain
    version in tests/test_torch_cuda.py."""
    if isinstance(case, str):
        pats, plens, texts, tlens = k5_cases.pairs(case)
    else:
        lp, lt = case
        pats, plens, texts, tlens = _protein_batch(lp + lt, 16, lp, lt)
    scheme = MatrixScheme(gap_open=10, gap_extend=1)
    want = jax_full(jnp.asarray(pats), jnp.asarray(plens),
                    jnp.asarray(texts), jnp.asarray(tlens),
                    scheme=JAX_BLOSUM62, atype=JAType[atype.name])
    got = full_score_batch(_t(pats), _t(plens), _t(texts), _t(tlens),
                           scheme=scheme, atype=atype)
    _equal(got, want)
    if case in SHAPES and atype == AlignmentType.LOCAL:
        # the planted homologs score high
        assert (got["score"][0::2].numpy() > 40).all()
    if case == "repeats" and atype == AlignmentType.LOCAL:
        # ties: full-length identical repeats score high
        assert (got["score"][:2].numpy() > 40).all()
    if case == "empty":
        assert got["p_end"][0] == got["p_end"][2] == 0


def test_matrix_directions_twin_equals_jax():
    """banded_directions_batch takes a matrix scheme too: score and
    every flag equal to the JAX twin's."""
    pats, plens, texts, tlens = _protein_batch(7, 8, 24, 40)
    want, wdirs = jax_dirs_twin(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(texts),
        jnp.asarray(tlens), scheme=JAX_BLOSUM62, atype=JAType.LOCAL,
        band_w=12)
    got, dirs = banded_directions_batch(
        _t(pats), _t(plens), _t(texts), _t(tlens), scheme=BLOSUM62,
        atype=AlignmentType.LOCAL, band_w=12, twin=True)
    _equal(got, want)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(wdirs))


def test_matrix_scheme_refused_by_flag_entry_and_past_sink_guard():
    pats, plens, texts, tlens = (_t(a) for a in _protein_batch(1, 8, 20, 30))
    with pytest.raises(ValueError, match="no substitution matrix"):
        wavefront_dp.wavefront_dirs(pats, plens, texts, tlens,
                                    scheme=BLOSUM62,
                                    atype=AlignmentType.LOCAL, band_w=30)
    # band_w = max(Lq, Lt) = 35 000 admits Lq up to ~16 k residues
    big_p = torch.zeros((1, 16_400), dtype=torch.int8)
    big_t = torch.zeros((1, 35_000), dtype=torch.int8)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="Lp=16400, Lt=35000"):
        full_score_batch(big_p, n, big_t, n, scheme=BLOSUM62,
                         atype=AlignmentType.LOCAL)


@pytest.mark.parametrize("with_quals", [False, True], ids=["q40", "quals"])
def test_hamming_and_gotoh_full_score_equal_jax(with_quals):
    rng = np.random.default_rng(11)
    R, L, LT = 24, 40, 48
    pats = rng.integers(0, 5, (R, L)).astype(np.int32)
    texts = rng.integers(0, 5, (R, LT)).astype(np.int32)
    texts[::2, :L] = pats[::2]
    plens = rng.integers(1, L + 1, R).astype(np.int32)
    tlens = rng.integers(1, LT + 1, R).astype(np.int32)
    quals = (rng.integers(0, 45, (R, L)).astype(np.int32) if with_quals
             else None)
    scheme = GotohScheme(match=1, mismatch_min=2, mismatch_max=6)
    jscheme = JScheme(match=1, mismatch_min=2, mismatch_max=6)
    jq = None if quals is None else jnp.asarray(quals)
    tq = None if quals is None else _t(quals)
    want = jax_hamming(jnp.asarray(pats), jnp.asarray(plens),
                       jnp.asarray(texts), jq, scheme=jscheme)
    got = hamming_score_batch(_t(pats), _t(plens), _t(texts), tq,
                              scheme=scheme)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for atype in AlignmentType:
        want = jax_full(jnp.asarray(pats), jnp.asarray(plens),
                        jnp.asarray(texts), jnp.asarray(tlens), jq,
                        scheme=jscheme, atype=JAType[atype.name])
        got = full_score_batch(_t(pats), _t(plens), _t(texts), _t(tlens),
                               tq, scheme=scheme, atype=atype)
        _equal(got, want)


@pytest.mark.parametrize("sigma", [3, 8, 22, 31])
def test_wavelet_rank_access_equal_jax(sigma):
    """Also at a length that is a multiple of 32, where the reference's
    clamped word gather reads the last word for rank(c, n): the port
    reads it the same way."""
    from nvbio_tpu.strings import wavelet as jw
    from nvbio_tpu_torch.strings import wavelet as tw

    rng = np.random.default_rng(sigma)
    for n in (1000, 1024):
        seq = rng.integers(0, sigma, n).astype(np.int32)
        jt, tt = jw.build_wavelet_tree(seq, sigma), tw.build_wavelet_tree(
            seq, sigma)
        for lvl_j, lvl_t in ((jt.words, tt.words),
                             (jt.block_rank, tt.block_rank),
                             (jt.node_start, tt.node_start),
                             (jt.node_ones, tt.node_ones)):
            np.testing.assert_array_equal(lvl_t.numpy(), np.asarray(lvl_j))
        cs = rng.integers(0, sigma, 256).astype(np.int32)
        iis = rng.integers(0, n + 1, 256).astype(np.int32)
        iis[:3] = (0, n, n - 1)
        want = jw.wt_rank(jt, jnp.asarray(cs), jnp.asarray(iis))
        got = tw.wt_rank(tt, _t(cs), _t(iis))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if n % 32:  # away from the clamp, both are the true counts
            true = [(seq[:i] == c).sum() for c, i in zip(cs, iis)]
            np.testing.assert_array_equal(got.numpy(), true)
        idx = rng.integers(0, n, 128).astype(np.int32)
        np.testing.assert_array_equal(
            tw.wt_access(tt, _t(idx)).numpy(),
            np.asarray(jw.wt_access(jt, jnp.asarray(idx))))
        np.testing.assert_array_equal(tw.wt_access(tt, _t(idx)).numpy(),
                                      seq[idx])


def test_wavelet_fm_backward_search_equals_jax():
    from nvbio_tpu.fmindex.wavelet_fm import (build_wavelet_fm_index as jb,
                                              wfm_backward_search as js)
    from nvbio_tpu_torch.fmindex.wavelet_fm import (
        build_wavelet_fm_index, wfm_backward_search)

    rng = np.random.default_rng(3)
    n, L = 5000, 8
    text = rng.integers(0, 20, n).astype(np.uint8)
    jfm, tfm = jb(text, sigma=22), build_wavelet_fm_index(text, sigma=22)
    np.testing.assert_array_equal(tfm.C.numpy(), np.asarray(jfm.C))
    assert tfm.primary == int(jfm.primary)
    starts = rng.integers(0, n - L, 32)
    seeds = np.concatenate([
        np.stack([text[s:s + L] for s in starts]).astype(np.int32),
        np.full((1, L), 21, np.int32),  # absent: '*' never occurs
        rng.integers(-2, 25, (8, L)).astype(np.int32)])  # out of range
    slens = rng.integers(0, L + 1, len(seeds)).astype(np.int32)
    for sl in (None, slens):
        want = js(jfm, jnp.asarray(seeds),
                  None if sl is None else jnp.asarray(sl))
        got = wfm_backward_search(tfm, _t(seeds),
                                  None if sl is None else _t(sl))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lo, hi = wfm_backward_search(tfm, _t(seeds[:33]))
    assert (hi[:32] > lo[:32]).all() and int(hi[32] - lo[32]) == 0


def test_protein_sw_cli_tsv_equals_reference(tmp_path, capsys):
    from nvbio_tpu.tools.protein_sw import main as ref_main
    from nvbio_tpu_torch.basic.alphabet import decode_protein
    from nvbio_tpu_torch.tools.protein_sw import main

    rng = np.random.default_rng(5)
    q = [decode_protein(rng.integers(0, 20, int(rng.integers(8, 40))))
         for _ in range(4)]
    t = [decode_protein(rng.integers(0, 20, int(rng.integers(8, 60))))
         for _ in range(6)]
    t[2] = "GG" + q[1][:20] + "WW"  # a planted homolog
    t[4] = "mkvX*" + t[4]  # lower case, X and stop codes
    (tmp_path / "q.fa").write_text("".join(f">q{i} d\n{s}\n"
                                           for i, s in enumerate(q)))
    (tmp_path / "t.fa").write_text("".join(f">t{i}\n{s[:30]}\n{s[30:]}\n"
                                           for i, s in enumerate(t)))
    args = [str(tmp_path / "q.fa"), str(tmp_path / "t.fa"), "--gap-open",
            "11", "--gap-extend", "2", "-o"]
    assert ref_main(args + [str(tmp_path / "ref.tsv"), "--cpu"]) == 0
    ref_err = capsys.readouterr().err
    assert main(args + [str(tmp_path / "port.tsv"), "--device", "cpu"]) == 0
    assert capsys.readouterr().err == ref_err
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "ref.tsv").read_bytes()
    assert len(got.splitlines()) == 1 + 4 * 6
