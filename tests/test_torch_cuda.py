"""CUDA kernels against their plain PyTorch versions, on the card: K1-K3
at their own bands, K4 for long patterns (Lp 2016) and for the wide
bands (band_w 63) that route() sends it from K1-K3-shaped calls, K5
(score and flags, shared-memory and scratch state), K6 (register and
scratch words), the two-pass wide-band CIGAR and sw_benchmark.

Marked ``cuda`` and skipped on machines without CUDA.  Imports no JAX,
so it runs on a GPU machine without it; there ``tests/conftest.py``
(which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import gzip
import os

import numpy as np
import pytest
import torch

from nvbio_tpu_torch.alignment.batched import (banded_directions_batch,
                                               banded_score_batch)
from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
from nvbio_tpu_torch.alignment.walk import runjump_walk
from nvbio_tpu_torch.ops import banded_dp, long_dp

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(__file__), "data")
SCHEMES = {
    AlignmentType.GLOBAL: GotohScheme(),
    AlignmentType.SEMI_GLOBAL: GotohScheme(gap_open=3, gap_extend=1,
                                           ref_gap_open=8, ref_gap_extend=4),
    AlignmentType.LOCAL: GotohScheme(match=2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _batch(seed, nb, lp, band_w, genome):
    """Windows of ``genome`` with planted, mutated patterns (N included)."""
    rng = np.random.default_rng(seed)
    n = len(genome)
    lt = lp + 2 * band_w
    ws = rng.integers(0, n - 4, nb)
    ws[:3] = [0, n - 1, n - lp]
    gpad = np.concatenate([genome, np.full(lt, 7, np.int8)])
    texts = gpad[ws[:, None] + np.arange(lt)]
    pats = texts[:, band_w:band_w + lp].copy()
    pats[pats == 7] = rng.integers(0, 4)
    mut = rng.random(pats.shape) < 0.05
    pats[mut] = rng.integers(0, 5, int(mut.sum()))
    plens = rng.integers(lp // 2, lp + 1, nb).astype(np.int32)
    plens[3] = 0
    tlens = np.clip(n - ws, 0, lt).astype(np.int32)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    return pats, plens, texts, tlens, quals, ws


@pytest.mark.parametrize("band_w", [7, 15, 31])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_kernels_match_plain(cuda, atype, band_w):
    genome = np.random.default_rng(1).integers(0, 4, 20_000).astype(np.int8)
    pats, plens, texts, tlens, quals, ws = _batch(band_w, 301, 40, band_w,
                                                  genome)
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    if atype == AlignmentType.GLOBAL:  # keep the goal cell in the band
        tlens = np.clip(plens + np.random.default_rng(2).integers(
            -band_w, band_w + 1, len(plens)), 0, tlens).astype(np.int32)
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    dev = [a.to(cuda) for a in cpu]
    want = banded_score_batch(*cpu, **kw)
    k1 = banded_dp.banded_score(*dev, **kw)
    gw = banded_dp.pack_genome_words(genome)
    k3 = banded_dp.banded_score_packed(
        dev[0], dev[1], gw.to(cuda), torch.from_numpy(ws).to(cuda), dev[3],
        dev[4], **kw)
    want3 = banded_dp.banded_score_packed(
        cpu[0], cpu[1], gw, torch.from_numpy(ws), cpu[3], cpu[4], **kw)
    want_r, want_d = banded_directions_batch(*cpu, **kw)
    k2_r, k2_d = banded_dp.banded_directions(*dev, **kw)
    torch.cuda.synchronize()
    assert (want["score"] > -(1 << 29)).float().mean() > 0.5  # paths exist
    for k in want:
        assert torch.equal(k1[k].cpu(), want[k]), ("K1", k)
        assert torch.equal(k3[k].cpu(), want3[k]), ("K3", k)
        assert torch.equal(k2_r[k].cpu(), want_r[k]), ("K2", k)
    assert torch.equal(k2_d.cpu(), want_d)


def _long_inputs(seed, nb, lp, band_w, atype):
    """Long patterns planted in their windows with substitutions, N and
    indel drift; GLOBAL window lengths near each pattern's length."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 60_000).astype(np.int8)
    pats, plens, texts, tlens, quals, ws = _batch(seed, nb, lp, band_w,
                                                  genome)
    for b in range(4, nb):  # drift: shift the pattern against the window
        sh = int(rng.integers(-band_w // 2, band_w // 2 + 1))
        pats[b] = np.roll(pats[b], sh)
    if atype == AlignmentType.GLOBAL:
        tlens = np.clip(plens + rng.integers(-band_w, band_w + 1, nb), 0,
                        tlens).astype(np.int32)
    return pats, plens, texts, tlens, quals, ws, genome


def _walk(res, dirs, band_w):
    i0 = res["p_end"].long()
    k0 = res["t_end"].long() - i0 + band_w
    return runjump_walk(dirs.reshape(dirs.shape[0], -1), 2 * band_w + 1,
                        i0, k0, res["score"] > -(1 << 29))


@pytest.mark.parametrize("band_w", [15, 63, 200])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k4_long_matches_plain(cuda, atype, band_w):
    """K4 score-only (symbol and packed windows) and with flags at Lp
    2016, bit-identical to the plain versions, walks included."""
    lp = 2016
    pats, plens, texts, tlens, quals, ws, genome = _long_inputs(
        band_w, 24, lp, band_w, atype)
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    dev = [a.to(cuda) for a in cpu]
    gw = banded_dp.pack_genome_words(genome)
    banded_dp.reset_launch_counts()
    got = banded_dp.banded_score(*dev, **kw)
    got3 = banded_dp.banded_score_packed(
        dev[0], dev[1], gw.to(cuda), torch.from_numpy(ws).to(cuda), dev[3],
        dev[4], **kw)
    got_r, got_d = banded_dp.banded_directions(*dev, **kw)
    torch.cuda.synchronize()
    assert long_dp.launch.launches == 3
    assert banded_dp.banded_score.launches == 0
    want = banded_score_batch(*cpu, **kw)
    want3 = banded_dp.banded_score_packed(
        cpu[0], cpu[1], gw, torch.from_numpy(ws), cpu[3], cpu[4], **kw)
    want_r, want_d = banded_directions_batch(*cpu, **kw)
    assert (want["score"] > -(1 << 29)).float().mean() > 0.5
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), ("score", k)
        assert torch.equal(got3[k].cpu(), want3[k]), ("packed", k)
        assert torch.equal(got_r[k].cpu(), want_r[k]), ("dirs", k)
    assert torch.equal(got_d.cpu(), want_d)
    for g, w in zip(_walk({k: v.cpu() for k, v in got_r.items()},
                          got_d.cpu(), band_w),
                    _walk(want_r, want_d, band_w)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_wide_band_short_calls_route_to_k4(cuda, atype):
    """--band 63 on short reads: K1-, K2- and K3-shaped calls launch K4
    and equal the plain versions."""
    band_w, lp = 63, 128
    pats, plens, texts, tlens, quals, ws, genome = _long_inputs(
        7, 301, lp, band_w, atype)
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    assert banded_dp.route(lp, band_w, False) == "K4"
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    dev = [a.to(cuda) for a in cpu]
    gw = banded_dp.pack_genome_words(genome)
    banded_dp.reset_launch_counts()
    k1 = banded_dp.banded_score(*dev, **kw)
    k3 = banded_dp.banded_score_packed(
        dev[0], dev[1], gw.to(cuda), torch.from_numpy(ws).to(cuda), dev[3],
        dev[4], **kw)
    k2_r, k2_d = banded_dp.banded_directions(*dev, **kw)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    assert counts == {"K1": 0, "K2": 0, "K3": 0, "K4": 3, "K5": 0,
                      "K5_dirs": 0, "K6": 0}
    want = banded_score_batch(*cpu, **kw)
    want3 = banded_dp.banded_score_packed(
        cpu[0], cpu[1], gw, torch.from_numpy(ws), cpu[3], cpu[4], **kw)
    want_r, want_d = banded_directions_batch(*cpu, **kw)
    for k in want:
        assert torch.equal(k1[k].cpu(), want[k]), ("K1", k)
        assert torch.equal(k3[k].cpu(), want3[k]), ("K3", k)
        assert torch.equal(k2_r[k].cpu(), want_r[k]), ("K2", k)
    assert torch.equal(k2_d.cpu(), want_d)


def test_k4_widest_shape(cuda):
    """The widest instantiation (512 threads x 4 cells) at the edge of
    the score-only reach, and directions at the edge of theirs."""
    atype = AlignmentType.SEMI_GLOBAL
    for band_w, with_dirs in ((971, False), (815, True)):
        pats, plens, texts, tlens, quals, _, _ = _long_inputs(
            band_w, 6, 700, band_w, atype)
        kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
        cpu = [torch.from_numpy(a)
               for a in (pats, plens, texts, tlens, quals)]
        dev = [a.to(cuda) for a in cpu]
        if with_dirs:
            (got, gd), (want, wd) = (
                banded_dp.banded_directions(*dev, **kw),
                banded_directions_batch(*cpu, **kw))
            assert torch.equal(gd.cpu(), wd)
        else:
            got = banded_dp.banded_score(*dev, **kw)
            want = banded_score_batch(*cpu, **kw)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (band_w, k)


@pytest.mark.parametrize("lp,band_w", [(10_000, 63), (4_000, 31)],
                         ids=["gotoh_long", "wide_cigar_pass2"])
def test_k4_at_sw_benchmark_shapes(cuda, lp, band_w):
    """K4 at the pattern lengths and bands sw_benchmark --long gives it
    (score-only at 10 kb, band_w 63; flags at 4 kb, band_w 31), walks
    included."""
    atype = AlignmentType.SEMI_GLOBAL
    pats, plens, texts, tlens, quals, _, _ = _long_inputs(
        lp, 8, lp, band_w, atype)
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    dev = [a.to(cuda) for a in cpu]
    got = banded_dp.banded_score(*dev, **kw)
    got_r, got_d = banded_dp.banded_directions(*dev, **kw)
    want = banded_score_batch(*cpu, **kw)
    want_r, want_d = banded_directions_batch(*cpu, **kw)
    assert (want["score"] > -(1 << 29)).float().mean() > 0.5
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), ("score", k)
        assert torch.equal(got_r[k].cpu(), want_r[k]), ("dirs", k)
    assert torch.equal(got_d.cpu(), want_d)
    for g, w in zip(_walk({k: v.cpu() for k, v in got_r.items()},
                          got_d.cpu(), band_w),
                    _walk(want_r, want_d, band_w)):
        assert torch.equal(g, w)


def test_golden_se_sam_on_cuda(cuda, tmp_path):
    """The golden fixture under --device cuda, through K3 and K2."""
    from test_torch_golden import write_golden_dataset

    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    write_golden_dataset(tmp_path)
    build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")])
    banded_dp.reset_launch_counts()
    mapr(["-x", str(tmp_path / "g.npz"), "-U", str(tmp_path / "r.fq"),
          "-S", str(tmp_path / "out.sam"), "--device", "cuda",
          "--batch", "128"])
    assert banded_dp.banded_score_packed.launches > 0
    assert banded_dp.banded_directions.launches > 0
    got = [ln for ln in open(tmp_path / "out.sam")
           if not ln.startswith("@PG")]
    want = list(gzip.open(os.path.join(DATA, "golden_se.sam.gz"), "rt"))
    assert got == want


def _wavefront_inputs(seed, nb, lp, band_w):
    """Patterns planted at offsets within the band, with substitutions,
    N and one deletion; ragged and zero lengths; a GLOBAL goal outside
    the band on lane 2."""
    rng = np.random.default_rng(seed)
    lt = lp + 2 * band_w
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    pats = rng.integers(0, 5, (nb, lp)).astype(np.int8)
    for b in range(nb):
        off = int(rng.integers(0, band_w + 1))
        cut = int(rng.integers(1, lp))
        seg = np.concatenate([pats[b, :cut], rng.integers(0, 4, 7),
                              pats[b, cut:]]).astype(np.int8)
        texts[b, off:off + len(seg)] = seg[:lt - off]
    plens = rng.integers(lp // 2, lp + 1, nb).astype(np.int32)
    tlens = rng.integers(lt // 2, lt + 1, nb).astype(np.int32)
    plens[0], tlens[1], tlens[2] = 0, 0, max(lp // 2 - band_w - 5, 0)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    return pats, plens, texts, tlens, quals


@pytest.mark.parametrize("band_w", [5, 96, 1100, 4200])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_matches_plain(cuda, atype, band_w):
    """K5 score-only and with flags (every byte), and the device walk
    over the kernel's flags, against the plain versions; band_w 4200
    keeps its state in device scratch instead of shared memory."""
    from nvbio_tpu_torch.alignment.wavefront_walk import (
        walk_wavefront_dirs_device)
    from nvbio_tpu_torch.ops import wavefront_dp

    lp, nb = (200, 4) if band_w > 1000 else (200, 9)
    cpu = [torch.from_numpy(a)
           for a in _wavefront_inputs(band_w, nb, lp, band_w)]
    dev = [a.to(cuda) for a in cpu]
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    banded_dp.reset_launch_counts()
    got = wavefront_dp.wavefront_score(*dev, **kw)
    got_r, got_d = wavefront_dp.wavefront_dirs(*dev, **kw)
    torch.cuda.synchronize()
    assert wavefront_dp.wavefront_score.launches == 1
    assert wavefront_dp.wavefront_dirs.launches == 1
    want = wavefront_dp.wavefront_score(*cpu, **kw)
    want_r, want_d = wavefront_dp.wavefront_dirs(*cpu, **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), ("score", k)
        assert torch.equal(got_r[k].cpu(), want_r[k]), ("dirs", k)
    assert torch.equal(got_d.cpu(), want_d)
    walk_k = walk_wavefront_dirs_device(got_d, got_r["p_end"],
                                        got_r["t_end"], band_w=band_w)
    walk_p = walk_wavefront_dirs_device(want_d, want_r["p_end"],
                                        want_r["t_end"], band_w=band_w)
    for g, w in zip(walk_k, walk_p):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("lp", [20, 100, 256, 257, 1000])
@pytest.mark.parametrize("atype", [AlignmentType.SEMI_GLOBAL,
                                   AlignmentType.GLOBAL],
                         ids=["semi_global", "global"])
def test_k6_matches_plain(cuda, atype, lp):
    """K6 with its words in registers (to 256 bp) and in scratch."""
    from nvbio_tpu_torch.alignment.myers import myers_edit_distance_batch
    from nvbio_tpu_torch.ops import myers

    rng = np.random.default_rng(lp)
    nb, lt = 300, lp + 40
    pats = rng.integers(0, 5, (nb, lp)).astype(np.int8)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    texts[::2, 11:11 + lp] = np.where(pats[::2] < 4, pats[::2], 0)[:, :lt - 11]
    plens = rng.integers(0, lp + 1, nb).astype(np.int32)
    tlens = rng.integers(0, lt + 1, nb).astype(np.int32)
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens)]
    got = myers.myers(*[a.to(cuda) for a in cpu], atype=atype)
    want = myers_edit_distance_batch(*cpu, atype=atype)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_wide_cigar_pass3_on_cuda(cuda):
    """The forced 850 bp deletion of tests/test_wide_cigar.py through
    K5, K5 with flags and the device walk: the same outputs as on the
    CPU."""
    from nvbio_tpu_torch.alignment.wide import wide_band_cigar_batch

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
    arrays = (pats, np.full(1, lp, np.int32), text[None, :lt],
              np.full(1, lt, np.int32), np.full((1, lp), 35, np.int32))
    cpu = [torch.from_numpy(x) for x in arrays]
    kw = dict(scheme=scheme, atype=AlignmentType.SEMI_GLOBAL, band_w=band_w)
    banded_dp.reset_launch_counts()
    got = wide_band_cigar_batch(*[x.to(cuda) for x in cpu], **kw)
    assert banded_dp.KERNELS["K5_dirs"].launches == 1
    want = wide_band_cigar_batch(*cpu, **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["tb_ok"][0]


def test_sw_benchmark_on_cuda(cuda, capsys):
    """The CLI on the card at a small size launches K1, K4, K5 and K6."""
    import json

    from nvbio_tpu_torch.tools.sw_benchmark import main

    banded_dp.reset_launch_counts()
    assert main(["--device", "cuda", "--long", "--batch", "4096", "--iters",
                 "1", "--long-len", "1000", "--wide-band", "1100"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {r["engine"] for r in rows} == {"cuda"}
    assert "gotoh_wide_1100" in [r["aligner"] for r in rows]
    counts = {k: f.launches for k, f in banded_dp.KERNELS.items()}
    assert all(counts[k] > 0 for k in ("K1", "K4", "K5", "K6")), counts
