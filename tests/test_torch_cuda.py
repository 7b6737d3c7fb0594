"""CUDA kernels against their plain PyTorch versions, on the card: K1-K3
at their own bands (every tier edge of their sub-warp groups), K1 and K3
at the mapper's extension shape (pad lanes, Lp 320, windows at the
genome's end), K4 for long patterns (Lp 2016-2017, its group tiers and
the block-per-alignment tiers above 128 cells) and for the wide bands
(band_w 32, 63) that route() sends it from K1-K3-shaped calls, K5 (score
and flags, shared-memory and scratch state; the formula score's banded
column-sweep tier at every strip edge, and its routing), K6 (its thread
and warp tiers, and the plan), K7 (every group tier edge, both
substitution forms), the two-pass wide-band CIGAR,
sw_benchmark, the golden SE and PE SAM under --device cuda, paired-end
map_reads (CUDA SAM = CPU SAM), -S *.bam (CUDA BAM = CPU BAM), and the
alignment modes: K4 at the LOCAL rescue's window-wide band, K2 at -a's
32 768 winners in LOCAL, hamming_backtrack_1 (-N 1's seed search) and
the SAM of --local, -N 1 and -a (CUDA SAM = CPU SAM), single-end
map_reads on a sharded index (CUDA SAM = CPU SAM), and the MEM and
q-gram mappers: find_mems (CUDA = CPU) and the SAM of mem_map and qmap
(CUDA SAM = CPU SAM); K5's matrix mode (protein SW) against its plain
version in shared-memory and scratch state, and the protein_sw TSV, the
wavelet FM-index search and the correct_reads FASTQ under --device cuda
equal to --device cpu; self_test --device cuda (K1 against its plain
version, the native CIGAR/MD builder), the shard-per-device mesh on
cuda:0 x 3 equal to the sequential sharded mappers (SE, PE, -a), and
fm_server's SE and PE SAM on cuda equal to the CPU server's.

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
    ws[:3] = [0, n - 1, n - lp][:nb]
    gpad = np.concatenate([genome, np.full(lt, 7, np.int8)])
    texts = gpad[ws[:, None] + np.arange(lt)]
    pats = texts[:, band_w:band_w + lp].copy()
    pats[pats == 7] = rng.integers(0, 4)
    mut = rng.random(pats.shape) < 0.05
    pats[mut] = rng.integers(0, 5, int(mut.sum()))
    plens = rng.integers(lp // 2, lp + 1, nb).astype(np.int32)
    tlens = np.clip(n - ws, 0, lt).astype(np.int32)
    plens[3:5], tlens[5:6] = (0, lp)[:len(plens[3:5])], 0  # edge lanes
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    return pats, plens, texts, tlens, quals, ws


#: scores past a signed byte: the group kernels' generic substitution
#: path (no byte table)
BIG = {AlignmentType.GLOBAL: GotohScheme(mismatch_min=150, mismatch_max=300),
       AlignmentType.SEMI_GLOBAL: GotohScheme(n_penalty=200),
       AlignmentType.LOCAL: GotohScheme(match=130)}


@pytest.mark.parametrize("nb,lp,big", [(301, 40, False), (1, 129, False),
                                       (64, 40, True)],
                         ids=["nb301_lp40", "nb1_lp129", "nb64_big_scores"])
@pytest.mark.parametrize("band_w", [0, 1, 7, 8, 15, 16, 31])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_kernels_match_plain(cuda, atype, band_w, nb, lp, big):
    """K1, K3 and K2 (flags and run-jump walks) at every edge of K2's
    group tiers (16, 32, 64 cells), an odd batch and a single lane, Lp
    off the staging chunk; zero-length and full-length patterns, a
    zero-length window, N; scores that fit the byte table and scores
    that do not; one launch each."""
    genome = np.random.default_rng(1).integers(0, 4, 20_000).astype(np.int8)
    pats, plens, texts, tlens, quals, ws = _batch(band_w + lp, nb, lp,
                                                  band_w, genome)
    kw = dict(scheme=(BIG if big else SCHEMES)[atype], atype=atype,
              band_w=band_w)
    if atype == AlignmentType.GLOBAL:  # keep the goal cell in the band
        tlens = np.clip(plens + np.random.default_rng(2).integers(
            -band_w, band_w + 1, len(plens)), 0, tlens).astype(np.int32)
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    dev = [a.to(cuda) for a in cpu]
    want = banded_score_batch(*cpu, **kw)
    gw = banded_dp.pack_genome_words(genome)
    banded_dp.reset_launch_counts()
    k1 = banded_dp.banded_score(*dev, **kw)
    k3 = banded_dp.banded_score_packed(
        dev[0], dev[1], gw.to(cuda), torch.from_numpy(ws).to(cuda), dev[3],
        dev[4], **kw)
    k2_r, k2_d = banded_dp.banded_directions(*dev, **kw)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    assert counts == {"K1": 1, "K2": 1, "K3": 1, "K4": 0, "K5": 0,
                      "K5_dirs": 0, "K5_matrix": 0, "K6": 0, "K7": 0}
    want3 = banded_dp.banded_score_packed(
        cpu[0], cpu[1], gw, torch.from_numpy(ws), cpu[3], cpu[4], **kw)
    want_r, want_d = banded_directions_batch(*cpu, **kw)
    if nb > 1 and not big:  # paths exist
        assert (want["score"] > -(1 << 29)).float().mean() > 0.5
    for k in want:
        assert torch.equal(k1[k].cpu(), want[k]), ("K1", k)
        assert torch.equal(k3[k].cpu(), want3[k]), ("K3", k)
        assert torch.equal(k2_r[k].cpu(), want_r[k]), ("K2", k)
    assert torch.equal(k2_d.cpu(), want_d)
    for g, w in zip(_walk({k: v.cpu() for k, v in k2_r.items()},
                          k2_d.cpu(), band_w),
                    _walk(want_r, want_d, band_w)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lp", [128, 320], ids=["lp128", "lp320"])
@pytest.mark.parametrize("big", [False, True], ids=["byte_table", "big"])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k1_k3_at_the_extension_shape(cuda, atype, big, lp):
    """K1 and K3 as the mapper's extension calls them: 100 bp reads in
    rows bucketed to 128 and in the CLI's --max-read-len 320, band_w 15,
    a batch (4 099) that no block's alignments divide, the kept lanes a
    prefix and zero-length pad lanes past it, and packed windows that
    start in the genome's last words (read past its end into the
    PACK_TAIL_WORDS zero words, as the plain version's clamp does)."""
    band_w, nb, live = 15, 4_099, 1_600
    genome = np.random.default_rng(5).integers(0, 4, 30_001).astype(np.int8)
    pats, plens, texts, tlens, quals, ws = _batch(lp, nb, lp, band_w,
                                                  genome)
    rng = np.random.default_rng(lp)
    plens[:live] = rng.integers(90, 101, live)
    plens[live:] = 0
    n = len(genome)
    ws[6:70] = n - 1 - 5 * np.arange(64)  # windows at the genome's end
    tlens[6:70] = np.clip(n - ws[6:70], 0, lp + 2 * band_w)
    texts[6:70] = 7
    for i in range(6, 70):
        texts[i, :tlens[i]] = genome[ws[i]:ws[i] + tlens[i]]
    if atype == AlignmentType.GLOBAL:
        tlens = np.clip(plens + rng.integers(-band_w, band_w + 1, nb), 0,
                        tlens).astype(np.int32)
    kw = dict(scheme=(BIG if big else SCHEMES)[atype], atype=atype,
              band_w=band_w)
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    dev = [a.to(cuda) for a in cpu]
    gw = banded_dp.pack_genome_words(genome)
    banded_dp.reset_launch_counts()
    k1 = banded_dp.banded_score(*dev, **kw)
    k3 = banded_dp.banded_score_packed(
        dev[0], dev[1], gw.to(cuda), torch.from_numpy(ws).to(cuda), dev[3],
        dev[4], **kw)
    torch.cuda.synchronize()
    assert (banded_dp.banded_score.launches,
            banded_dp.banded_score_packed.launches) == (1, 1)
    want = banded_score_batch(*cpu, **kw)
    want3 = banded_dp.banded_score_packed(
        cpu[0], cpu[1], gw, torch.from_numpy(ws), cpu[3], cpu[4], **kw)
    if not big:
        assert (want["score"][:live] > -(1 << 29)).float().mean() > 0.5
    for k in want:
        assert torch.equal(want3[k], want[k]), ("K3 plain = K1 plain", k)
        assert torch.equal(k1[k].cpu(), want[k]), ("K1", k)
        assert torch.equal(k3[k].cpu(), want3[k]), ("K3", k)


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


@pytest.mark.parametrize("lp,band_w", [(2016, 15), (2017, 31), (2016, 32),
                                       (2017, 63), (2017, 64), (2016, 200)])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k4_long_matches_plain(cuda, atype, lp, band_w):
    """K4 score-only (symbol and packed windows) and with flags at Lp
    2016-2017: its group tiers (32, 64, 128 cells, at their edges) and
    the block-per-alignment tiers past 128 cells, bit-identical to the
    plain versions, walks included."""
    pats, plens, texts, tlens, quals, ws, genome = _long_inputs(
        band_w, 25, lp, band_w, atype)
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


@pytest.mark.parametrize("lp,band_w,big", [(128, 63, False),
                                           (129, 32, False),
                                           (128, 63, True)],
                         ids=["lp128_w63", "lp129_w32", "lp128_w63_big"])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_wide_band_short_calls_route_to_k4(cuda, atype, lp, band_w, big):
    """--band 63 on short reads (and band_w 32, the first band past 64
    cells): K1-, K2- and K3-shaped calls launch K4 and equal the plain
    versions, walks included; also with scores past a signed byte."""
    pats, plens, texts, tlens, quals, ws, genome = _long_inputs(
        7, 301, lp, band_w, atype)
    kw = dict(scheme=(BIG if big else SCHEMES)[atype], atype=atype,
              band_w=band_w)
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
                      "K5_dirs": 0, "K5_matrix": 0, "K6": 0, "K7": 0}
    want = banded_score_batch(*cpu, **kw)
    want3 = banded_dp.banded_score_packed(
        cpu[0], cpu[1], gw, torch.from_numpy(ws), cpu[3], cpu[4], **kw)
    want_r, want_d = banded_directions_batch(*cpu, **kw)
    for k in want:
        assert torch.equal(k1[k].cpu(), want[k]), ("K1", k)
        assert torch.equal(k3[k].cpu(), want3[k]), ("K3", k)
        assert torch.equal(k2_r[k].cpu(), want_r[k]), ("K2", k)
    assert torch.equal(k2_d.cpu(), want_d)
    for g, w in zip(_walk({k: v.cpu() for k, v in k2_r.items()},
                          k2_d.cpu(), band_w),
                    _walk(want_r, want_d, band_w)):
        assert torch.equal(g, w)


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


def _golden_pe(d):
    """The golden paired-end dataset, made as tests/test_golden.py:42
    makes it (with the port's copies of the simulator and writers)."""
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_pairs

    g = random_genome(150_000, seed=777)
    write_fasta(str(d / "g.fa"), [("golden_pe_ref", g)])
    sim = simulate_pairs(g, 120, 100, insert_mean=280, insert_sd=25,
                         error_rate=0.02, seed=778)
    for m in (1, 2):
        write_fastq(str(d / f"r{m}.fq"),
                    [(f"p{i}", sim[f"seqs{m}"][i].astype(np.uint8),
                      sim[f"quals{m}"][i]) for i in range(120)])


def test_golden_pe_sam_on_cuda(cuda, tmp_path):
    """The golden paired-end fixture under --device cuda, through K3,
    K2 and K4 (the rescue)."""
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    _golden_pe(tmp_path)
    build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")])
    banded_dp.reset_launch_counts()
    assert mapr(["-x", str(tmp_path / "g.npz"), "-1",
                 str(tmp_path / "r1.fq"), "-2", str(tmp_path / "r2.fq"),
                 "-S", str(tmp_path / "out.sam"), "--device", "cuda",
                 "--batch", "128"]) == 0
    counts = {k: f.launches for k, f in banded_dp.KERNELS.items()}
    assert all(counts[k] > 0 for k in ("K2", "K3", "K4")), counts
    got = [ln for ln in open(tmp_path / "out.sam")
           if not ln.startswith("@PG")]
    want = list(gzip.open(os.path.join(DATA, "golden_pe.sam.gz"), "rt"))
    assert got == want


def test_bam_on_cuda_equals_cpu(cuda, tmp_path):
    """-S *.bam on the golden single-end dataset: BGZF BAM whose
    decompressed bytes are the same under --device cuda and --device cpu,
    the @PG header line aside."""
    from test_torch_golden import write_golden_dataset

    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    write_golden_dataset(tmp_path)
    build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")])
    got = {}
    for dev in ("cuda", "cpu"):
        path = tmp_path / f"{dev}.bam"
        assert mapr(["-x", str(tmp_path / "g.npz"), "-U",
                     str(tmp_path / "r.fq"), "-S", str(path), "--device",
                     dev, "--batch", "128"]) == 0
        raw = gzip.decompress(path.read_bytes())
        assert raw[:4] == b"BAM\x01"
        n_text = int.from_bytes(raw[4:8], "little")
        text = raw[8:8 + n_text].decode().splitlines(keepends=True)
        got[dev] = ([ln for ln in text if not ln.startswith("@PG")],
                    raw[8 + n_text:])
    assert got["cuda"] == got["cpu"]


#: (Lp, band_w) at every edge of K7's group tiers, by the live cells
#: ops.banded_dp.k7_live_range gives (a band of 2w + 1 cells, less those
#: below w - Lp8): 15 | 17 (the band is odd while w <= Lp8, so no band
#: has 16), 31 | 33, 63 | 65 and 64 | 65 past k 0, 127 | 129, 128, 255 |
#: 256 | 257, 512 | 513; the widest live band the guard admits at Lp 16
#: (736 cells) and Lp 32 (404), and at Lp 128 (183, the widest whose
#: cells left of the band are pinned)
K7_SHAPES = [(32, 7), (32, 8), (64, 15), (64, 16), (64, 31), (64, 32),
             (16, 47), (16, 48), (128, 63), (128, 64), (16, 111),
             (16, 238), (16, 239), (16, 240), (16, 495), (16, 496),
             (16, 719), (32, 371), (128, 91)]


def _k7_case(lp, band_w, atype, nb=301):
    """K7 inputs: windows of a seeded genome with planted, mutated
    patterns (N included), an odd batch (the last pair's second
    alignment is empty), zero-length patterns and windows, lanes with no
    path (tlen + band_w < plen) and, for GLOBAL, goal cells in and out of
    the band."""
    genome = np.random.default_rng(3).integers(0, 4, 20_000).astype(np.int8)
    pats, plens, texts, tlens, quals, _ = _batch(lp + band_w, nb, lp,
                                                 band_w, genome)
    rng = np.random.default_rng(4)
    plens[5:9], tlens[5:9] = lp, max(lp - band_w - 2, 0)  # no path
    if atype == AlignmentType.GLOBAL:  # goal cells in and out of the band
        tlens[9:] = np.clip(plens[9:] + rng.integers(
            -2 * band_w, 2 * band_w + 1, len(plens) - 9), 0, tlens[9:])
    return [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]


@pytest.mark.parametrize("lp,band_w", K7_SHAPES,
                         ids=[f"lp{lp}_w{w}" for lp, w in K7_SHAPES])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k7_matches_plain(cuda, atype, lp, band_w):
    """K7 (compute_dtype="int16") against its plain version at every
    tier edge (K7_SHAPES), one launch, no K1."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch16

    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    assert banded_dp.int16_ok(lp, band_w, SCHEMES[atype])
    cpu = _k7_case(lp, band_w, atype)
    want = banded_score_batch16(*cpu, **kw)
    banded_dp.reset_launch_counts()
    got = banded_dp.banded_score(*[a.to(cuda) for a in cpu],
                                 compute_dtype="int16", **kw)
    torch.cuda.synchronize()
    assert banded_dp.KERNELS["K7"].launches == 1
    assert banded_dp.banded_score.launches == 0
    assert (want["score"] > -(1 << 29)).float().mean() > 0.3
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


#: schemes whose scores pass a signed byte (K7's compare-and-select
#: substitution), inside the guard at every K7_BYTE_SHAPES shape
K7_BIG = {AlignmentType.GLOBAL: GotohScheme(mismatch_min=129,
                                            mismatch_max=130),
          AlignmentType.SEMI_GLOBAL: GotohScheme(n_penalty=130),
          AlignmentType.LOCAL: GotohScheme(match=130)}
#: (Lp, band_w) on each tier that has the compare form: 4 x 4 (15
#: cells), 4 x 8 (25), 8 x 8 (35 from k 0, cells left of the band
#: pinned; 43 from k 10, the widest band such a scheme gets at Lp 16)
K7_BYTE_SHAPES = [(16, 7), (16, 12), (32, 17), (16, 26)]


@pytest.mark.parametrize("lp,band_w", K7_BYTE_SHAPES,
                         ids=[f"lp{lp}_w{w}" for lp, w in K7_BYTE_SHAPES])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k7_scores_past_a_byte(cuda, atype, lp, band_w):
    """K7 with scores past a signed byte (the compare form) against its
    plain version, on every tier that has it."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch16

    kw = dict(scheme=K7_BIG[atype], atype=atype, band_w=band_w)
    assert banded_dp.int16_ok(lp, band_w, K7_BIG[atype])
    cpu = _k7_case(lp, band_w, atype)
    want = banded_score_batch16(*cpu, **kw)
    banded_dp.reset_launch_counts()
    got = banded_dp.banded_score(*[a.to(cuda) for a in cpu],
                                 compute_dtype="int16", **kw)
    assert banded_dp.KERNELS["K7"].launches == 1
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("scheme", [GotohScheme(n_penalty=-1),
                                    GotohScheme(mismatch_min=7,
                                                mismatch_max=6)],
                         ids=["negative_penalty", "mismatch_min_above_max"])
def test_k7_refuses_schemes_outside_the_convention(cuda, scheme):
    """K7's headroom argument needs penalties >= 0, and int16_ok's bound
    mismatch_min <= mismatch_max: the wrapper raises on CUDA rather than
    launch."""
    cpu = _k7_case(32, 7, AlignmentType.SEMI_GLOBAL, nb=8)
    assert banded_dp.int16_ok(32, 7, scheme)
    with pytest.raises(ValueError, match="penalties >= 0 and mismatch_min"):
        banded_dp.banded_score(*[a.to(cuda) for a in cpu], scheme=scheme,
                               atype=AlignmentType.SEMI_GLOBAL, band_w=7,
                               compute_dtype="int16")


def test_pe_sam_on_cuda_equals_cpu(cuda, tmp_path):
    """Paired-end map_reads: --device cuda SAM = --device cpu SAM on 64
    pairs, every fourth with mate 2's seeds broken so that rescue (K4 on
    the card) places it; K2, K3 and K4 launched."""
    import json

    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_pairs

    g = random_genome(150_000, seed=9)
    write_fasta(str(tmp_path / "g.fa"), [("pe_ref", g)])
    sim = simulate_pairs(g, 64, 100, insert_mean=280, insert_sd=25,
                         error_rate=0.02, seed=10)
    s2 = sim["seqs2"].copy()
    for k in range(4, 100, 12):
        s2[::4, k] = (s2[::4, k] + 1) % 4
    write_fastq(str(tmp_path / "r1.fq"), [
        (f"p{i}", sim["seqs1"][i].astype(np.uint8), sim["quals1"][i])
        for i in range(64)])
    write_fastq(str(tmp_path / "r2.fq"), [
        (f"p{i}", s2[i].astype(np.uint8), sim["quals2"][i])
        for i in range(64)])
    build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")])
    sams = {}
    for dev in ("cuda", "cpu"):
        banded_dp.reset_launch_counts()
        assert mapr(["-x", str(tmp_path / "g.npz"), "-1",
                     str(tmp_path / "r1.fq"), "-2", str(tmp_path / "r2.fq"),
                     "-S", str(tmp_path / f"{dev}.sam"), "--device", dev,
                     "--batch", "64", "--stats",
                     str(tmp_path / f"{dev}.json")]) == 0
        if dev == "cuda":
            counts = {k: f.launches for k, f in banded_dp.KERNELS.items()}
            assert all(counts[k] > 0 for k in ("K2", "K3", "K4")), counts
        sams[dev] = [ln for ln in open(tmp_path / f"{dev}.sam")
                     if not ln.startswith("@PG")]
    assert sams["cuda"] == sams["cpu"]
    stats = json.load(open(tmp_path / "cuda.json"))
    assert stats["rescued"] > 0 and stats["proper_pairs"] >= 56


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
    """K5 score-only (the tier the gate picks, and the diagonal kernel
    by its C entry) and with flags (the banded sweep's flag tier, every
    word), and the device walk over the kernel's flags, against the plain
    versions; band_w 4200 keeps the diagonal kernel's state in device
    scratch instead of shared memory."""
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
    assert wavefront_dp.wavefront_dirs.sweep_launches == 1
    assert wavefront_dp.wavefront_score.sweep_launches == 1  # Lp 200
    diag = wavefront_dp._launch_k5(*dev, kw["scheme"], atype, band_w,
                                   "k5_wavefront_score")
    want = wavefront_dp.wavefront_score(*cpu, **kw)
    want_r, want_d = wavefront_dp.wavefront_dirs(*cpu, **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), ("score", k)
        assert torch.equal(diag[k].cpu(), want[k]), ("diagonal score", k)
        assert torch.equal(got_r[k].cpu(), want_r[k]), ("dirs", k)
    assert torch.equal(got_d.cpu(), want_d)
    _assert_same_walks(got_r, got_d, want_r, want_d, band_w, lp,
                       cpu[2].shape[1])


def _assert_same_walks(got_r, got_d, want_r, want_d, band_w, lp, lt):
    """The device walk over the kernel's flags (on the card) = the device
    walk over the plain flags (on the CPU)."""
    from nvbio_tpu_torch.alignment.wavefront_walk import (
        walk_wavefront_dirs_device)

    kw = dict(band_w=band_w, lp=lp, lt=lt)
    walk_k = walk_wavefront_dirs_device(got_d, got_r["p_end"],
                                        got_r["t_end"], **kw)
    walk_p = walk_wavefront_dirs_device(want_d, want_r["p_end"],
                                        want_r["t_end"], **kw)
    for g, w in zip(walk_k, walk_p):
        assert torch.equal(g.cpu(), w)


def _k5_dirs_on_card(cuda, cpu, atype, band_w, score_lanes):
    """wavefront_dirs on the card (the flag tier on its own grid) = its
    plain version on the CPU: every flag word, the result, the device
    walk; the result on ``score_lanes`` also = wavefront_score's on the
    card.  Returns the tier's grid, ``dirs_plan``'s (blocks an alignment,
    warps a block)."""
    from nvbio_tpu_torch.ops import wavefront_dp

    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    dev = [a.to(cuda) for a in cpu]
    banded_dp.reset_launch_counts()
    got_r, got_d = wavefront_dp.wavefront_dirs(*dev, **kw)
    torch.cuda.synchronize()
    assert wavefront_dp.wavefront_dirs.launches == 1
    assert wavefront_dp.wavefront_dirs.sweep_launches == 1
    lp = cpu[0].shape[1]
    assert got_d.shape == (len(cpu[1]), *wavefront_dp.flag_shape(lp, band_w),
                           32)
    want_r, want_d = wavefront_dp.wavefront_dirs(*cpu, **kw)
    for k in want_r:
        assert torch.equal(got_r[k].cpu(), want_r[k]), k
    assert torch.equal(got_d.cpu(), want_d)
    score = wavefront_dp.wavefront_score(*dev, **kw)
    for k in score:
        assert torch.equal(score[k][score_lanes].cpu(),
                           want_r[k][score_lanes]), ("score", k)
    _assert_same_walks(got_r, got_d, want_r, want_d, band_w, lp,
                       cpu[2].shape[1])
    return wavefront_dp.dirs_plan(len(cpu[1]), lp, cuda)


@pytest.mark.parametrize("band_w", [5, 256, 2000])
@pytest.mark.parametrize("lp", [1, 255, 256, 257, 4000])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_band_dirs_tier_matches_plain(cuda, atype, lp, band_w):
    """K5's flag tier (the banded column sweep with one flag word a lane a
    step) at every strip edge and pass-3's Lp 4 000, at bands narrower
    than a lane's rows, of a strip and pass 3's 2 000: tests/_k5_band_cases'
    edge lanes, _wavefront_inputs' lanes (Lp >= 2) and one lane whose
    plen exceeds Lp (where the other K5 tiers report plen as the end and
    the plain version 0): every flag word, the result and the device walk
    equal the plain version's, on the tier's own grid (at these 8 lanes
    one block an alignment of its S strips, at Lp 4 000 a cluster of 4
    blocks of 4), and the result equals wavefront_score's on every lane
    with plen <= Lp."""
    import _k5_band_cases as k5_cases

    lt = lp + 2 * band_w
    lanes = [k5_cases.batch(lp, band_w, lt, seed=lp + band_w)]
    if lp >= 2:
        lanes.append(_wavefront_inputs(lp + band_w, 3, lp, band_w))
    past = k5_cases.batch(lp, band_w, lt, seed=lp + band_w + 1)
    lanes.append([x[3:] for x in past])
    cpu = [torch.from_numpy(np.concatenate(a)) for a in zip(*lanes)]
    cpu[1][-1] = lp + 5
    nb = len(cpu[1])
    plan = _k5_dirs_on_card(cuda, cpu, atype, band_w, slice(0, nb - 1))
    assert plan == ((4, 4) if lp == 4000 else (1, -(-lp // 256)))


def _k5_grid_inputs(nb, lp, band_w):
    """_wavefront_inputs' lanes (0-2: plen 0, tlen 0, a goal outside the
    band) with lanes 3.. ending within the band (tlen = plen + band_w //
    2), so that their GLOBAL and SEMI_GLOBAL walks cross the strips even
    at narrow bands."""
    pats, plens, texts, tlens, quals = _wavefront_inputs(lp + band_w, nb, lp,
                                                         band_w)
    tlens[3:] = np.minimum(plens[3:] + band_w // 2, texts.shape[1])
    return [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]


# (lanes, Lp, band_w, (blocks an alignment, warps a block)) on a card of
# 80 to 159 SMs (the H100's 132): the shape alone picks the grid
_DIRS_GRIDS = [
    (4, 65537, 16, (1, 32)),   # 257 strips: no cluster of <= 32 a block
    (40, 16385, 16, (1, 32)),  # 65 strips: 2 blocks need 33, 4 need 160 SMs
    (200, 9000, 16, (1, 32)),  # 36 strips, the batch fills the SMs
    (200, 4000, 256, (1, 16)),  # one pass
    (4, 2500, 256, (2, 5)),
    (4, 8193, 16, (8, 5)),
    (4, 9000, 256, (8, 5)),
    (40, 8193, 16, (2, 17)),   # 32-warp blocks in a cluster
    (4, 65536, 16, (8, 32)),   # the widest cluster of the widest blocks
]


@pytest.mark.parametrize(
    "case", _DIRS_GRIDS, ids=lambda c: f"{c[0]}x{c[1]}-w{c[2]}")
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_band_dirs_grids(cuda, atype, case):
    """K5's flag tier on each grid the shape picks: one block an alignment
    taking more than 32 strips in passes of 32 through the boundary row in
    device scratch (9, 3 and 2 passes) or the batch's 16 in one pass
    where it fills the SMs, and clusters of 2 and 8 blocks of 5, 17 and 32
    warps (4: test_k5_band_dirs_tier_matches_plain at Lp 4 000); every
    flag word, the result, the walk and wavefront_score against the plain
    version, and the grid asserted."""
    nb, lp, band_w, plan = case
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 80 <= sms < 160, sms  # the grids above assume it
    cpu = _k5_grid_inputs(nb, lp, band_w)
    assert _k5_dirs_on_card(cuda, cpu, atype, band_w, slice(None)) == plan


def _k5_score_on_card(cuda, cpu, atype, band_w):
    """wavefront_score on the card = its plain version on the CPU;
    returns (launches, banded-tier launches) of the card's call."""
    from nvbio_tpu_torch.ops import wavefront_dp

    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    banded_dp.reset_launch_counts()
    got = wavefront_dp.wavefront_score(*[a.to(cuda) for a in cpu], **kw)
    torch.cuda.synchronize()
    counts = (wavefront_dp.wavefront_score.launches,
              wavefront_dp.wavefront_score.sweep_launches)
    want = wavefront_dp.wavefront_score(*cpu, **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    return counts


@pytest.mark.parametrize("band_w", [256, 300, 2000])
@pytest.mark.parametrize("lp", [1, 255, 256, 257, 513, 4000])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_band_tier_matches_plain(cuda, atype, lp, band_w):
    """K5's banded column-sweep tier at every strip edge (a lane's 8
    rows, a strip's 256, a second strip, sw_benchmark's 4 000 in 16),
    at bands 256, 300 and sw_benchmark's 2 000 (narrower ones:
    test_k5_score_kernels_narrow_bands): tests/_k5_band_cases' edge
    lanes (ties, plen 256 / 257 / Lp, tlen below the last strip's band,
    GLOBAL goals clipped to either edge, N, qualities 0-41), which
    tests/test_torch_wavefront.py holds the plain version to the JAX
    kernel on, and _wavefront_inputs' lanes (Lp >= 2)."""
    import _k5_band_cases as k5_cases

    lt = lp + 2 * band_w
    lanes = [k5_cases.batch(lp, band_w, lt, seed=lp + band_w)]
    if lp >= 2:
        lanes.append(_wavefront_inputs(lp + band_w, 4, lp, band_w))
    cpu = [torch.from_numpy(np.concatenate(a)) for a in zip(*lanes)]
    assert _k5_score_on_card(cuda, cpu, atype, band_w) == (1, 1)


@pytest.mark.parametrize("band_w", [0, 1, 8, 64, 128, 255])
@pytest.mark.parametrize("lp", [255, 257, 1000])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_score_kernels_narrow_bands(cuda, atype, lp, band_w):
    """Both K5 score kernels, the banded column sweep and the diagonal
    kernel, launched by their C entries whatever the gate picks, at bands
    below sw_benchmark's (a row's band narrower than a lane's 8 rows, a
    strip's 256 rows, the band of one cell), on tests/_k5_band_cases'
    edge lanes and _wavefront_inputs' lanes: each equal to the plain
    version."""
    import _k5_band_cases as k5_cases
    from nvbio_tpu_torch.ops import wavefront_dp

    lt = lp + 2 * band_w
    cpu = [torch.from_numpy(np.concatenate(a)) for a in zip(
        k5_cases.batch(lp, band_w, lt, seed=lp + band_w),
        _wavefront_inputs(lp + band_w, 4, lp, band_w))]
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    want = wavefront_dp.wavefront_score(*cpu, **kw)
    for entry in ("k5_band_score", "k5_wavefront_score"):
        got = wavefront_dp._launch_k5(*[a.to(cuda) for a in cpu],
                                      kw["scheme"], atype, band_w, entry)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (entry, k)


@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_band_tier_routing(cuda, atype):
    """Lp 8 192 (32 strips, the tier's widest block) takes the tier, and
    so do narrow bands (255, 16); Lp 8 193 stays on the diagonal kernel;
    every wavefront_dirs call takes the flag tier; all equal their plain
    versions."""
    from nvbio_tpu_torch.ops import wavefront_dp

    assert wavefront_dp.BAND_MAX_LP == 8192
    for lp, band_w, tier in ((8192, 256, 1), (8193, 256, 0), (600, 255, 1),
                             (600, 16, 1)):
        cpu = [torch.from_numpy(a) for a in
               _wavefront_inputs(lp, 3, lp, band_w)]
        assert _k5_score_on_card(cuda, cpu, atype, band_w) == (1, tier)
    cpu = [torch.from_numpy(a) for a in _wavefront_inputs(3, 3, 300, 256)]
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=256)
    banded_dp.reset_launch_counts()
    got_r, got_d = wavefront_dp.wavefront_dirs(*[a.to(cuda) for a in cpu],
                                               **kw)
    assert wavefront_dp.wavefront_dirs.launches == 1
    assert wavefront_dp.wavefront_dirs.sweep_launches == 1
    assert wavefront_dp.wavefront_score.launches == 0
    want_r, want_d = wavefront_dp.wavefront_dirs(*cpu, **kw)
    for k in want_r:
        assert torch.equal(got_r[k].cpu(), want_r[k]), k
    assert torch.equal(got_d.cpu(), want_d)


def _k6_inputs(seed, nb, lp, lt):
    """Patterns (N included) planted in their texts at offset 11, ragged
    and zero lengths, and on every third lane poly-A runs the text never
    matches, so that the add's all-ones propagate crosses lanes and
    strips."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(0, 5, (nb, lp)).astype(np.int8)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    n = min(lp, lt - 11)
    texts[::2, 11:11 + n] = np.where(pats[::2, :n] < 4, pats[::2, :n], 0)
    for b in range(0, nb, 3):
        lo = int(rng.integers(0, max(lp - 64, 1)))
        hi = min(lp, lo + int(rng.integers(64, 2048)))
        pats[b, lo:hi] = 0
        texts[b] = np.where(texts[b] == 0, 1 + texts[b] % 3, texts[b])
    plens = rng.integers(0, lp + 1, nb).astype(np.int32)
    plens[:2] = (lp, 0)[:nb]
    tlens = rng.integers(0, lt + 1, nb).astype(np.int32)
    tlens[:1] = lt
    return pats, plens, texts, tlens


@pytest.mark.parametrize("lp", [20, 100, 256, 257, 288, 1000, 1024, 1025,
                                2049, 8193, 16385, 32768, 32769, 144640])
@pytest.mark.parametrize("atype", [AlignmentType.SEMI_GLOBAL,
                                   AlignmentType.GLOBAL],
                         ids=["semi_global", "global"])
def test_k6_matches_plain(cuda, atype, lp):
    """K6 on its thread tier (to 8 words, 256 bp) and its warp tier: one
    warp an alignment to 32 words, then strips of 2 and of 8 words a lane
    (from 16 385 bp, 8 words a lane on 3 strips, on 4 lanes of 512
    columns, to the guard's 4 520 words), each call asserted on the tier
    myers_plan gives, against its plain version."""
    from nvbio_tpu_torch.alignment.myers import myers_edit_distance_batch
    from nvbio_tpu_torch.ops import myers

    nb, lt = (4, 512) if lp > 8193 else (300, lp + 40)
    cpu = [torch.from_numpy(a) for a in _k6_inputs(lp, nb, lp, lt)]
    banded_dp.reset_launch_counts()
    got = myers.myers(*[a.to(cuda) for a in cpu], atype=atype)
    assert myers.myers.launches == 1
    assert myers.myers.warp_launches == (myers.myers_plan(lp)[0]
                                         == myers.WARP)
    assert (myers.myers_plan(lp)[0] == myers.WARP) == (lp > 256)
    want = myers_edit_distance_batch(*cpu, atype=atype)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_k6_plan_matches_python(cuda):
    """The C entry k6_plan (the plan k6_myers launches by) equals
    myers.myers_plan at every W from 1 to the guard's 4 520 words."""
    import ctypes

    from nvbio_tpu_torch.ops import _build, myers

    lib = _build.library()
    for words in range(1, 4521):
        lp = 32 * words
        plan = (ctypes.c_int * 3)()
        assert lib.k6_plan(lp, plan) == 0, lp
        assert tuple(plan) == myers.myers_plan(lp), (lp, tuple(plan))


def test_wide_cigar_pass3_on_cuda(cuda):
    """The forced 850 bp deletion of tests/test_wide_cigar.py through
    K5, K5 with flags (the flag tier) and the device walk: the same
    outputs as on the CPU."""
    from nvbio_tpu_torch.alignment.wide import wide_band_cigar_batch
    from nvbio_tpu_torch.ops import wavefront_dp

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
    assert wavefront_dp.wavefront_dirs.sweep_launches == 1
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


def _rescue_inputs(seed, nb, lp, band_w):
    """Mate-rescue windows (paired._rescue): Lt = lp + 2 * band_w, each
    pattern planted at a start the band reaches (0..band_w) with 3%
    substitutions and N,
    every eighth pattern random (no place), ragged lengths, windows cut
    by the genome's end."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 200_000).astype(np.int8)
    n, lt = len(genome), lp + 2 * band_w
    ws = rng.integers(0, n - 200, nb)
    ws[:2] = [n - lt // 2, n - 150]
    gpad = np.concatenate([genome, np.full(lt, 7, np.int8)])
    texts = gpad[ws[:, None] + np.arange(lt)]
    off = rng.integers(0, band_w + 1, nb)
    pats = gpad[np.minimum((ws + off)[:, None] + np.arange(lp),
                           len(gpad) - 1)]
    pats[::8] = rng.integers(0, 4, (len(pats[::8]), lp))
    pats = np.where(pats == 7, rng.integers(0, 4, pats.shape), pats)
    mut = rng.random(pats.shape) < 0.03
    pats[mut] = rng.integers(0, 5, int(mut.sum()))
    plens = rng.integers(lp * 3 // 4, lp + 1, nb).astype(np.int32)
    plens[2] = 0
    pats = np.where(np.arange(lp) < plens[:, None], pats, 7).astype(np.int8)
    tlens = np.clip(n - ws, 0, lt).astype(np.int32)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    return pats, plens, texts.astype(np.int8), tlens, quals


@pytest.mark.parametrize("atype", [AlignmentType.LOCAL,
                                   AlignmentType.SEMI_GLOBAL],
                         ids=["local", "semi_global"])
def test_k4_at_the_local_rescue_band(cuda, atype):
    """K4 at PE --local's rescue call (paired._rescue with no chunk plan:
    band_w = maxins + 2 * 15 = 530, 1 061 cells, Lp 128, Lt 1 188), on
    the column sweep (wide_plan's tier), against its plain version (the
    twin the reference's rescue runs) bit for bit; SEMI_GLOBAL too (a
    score-min too permissive for the chunk plan takes the same band)."""
    lp, band_w = 128, 530
    assert banded_dp.route(lp, band_w, False) == "K4"
    assert long_dp.wide_plan(lp, band_w) == (long_dp.SWEEP, 4,
                                             long_dp.SWEEP_WARPS)
    scheme = GotohScheme(match=2) if atype == AlignmentType.LOCAL else \
        GotohScheme()
    kw = dict(scheme=scheme, atype=atype, band_w=band_w)
    cpu = [torch.from_numpy(a) for a in _rescue_inputs(3, 300, lp, band_w)]
    banded_dp.reset_launch_counts()
    got = banded_dp.banded_score(*[a.to(cuda) for a in cpu], **kw)
    torch.cuda.synchronize()
    assert long_dp.launch.launches == 1
    assert long_dp.launch.sweep_launches == 1
    want = banded_score_batch(*cpu, **kw)
    placed = want["score"] > (0 if atype == AlignmentType.LOCAL else -100)
    assert placed.float().mean() > 0.5  # most lanes have their pattern
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def _sweep_inputs(seed, nb, lp, band_w, lt, atype):
    """Windows of a random genome with patterns planted at a start the
    band reaches, 4 % substitutions and N in patterns and texts, ragged
    pattern and window lengths (windows clamped below Lt), and the sweep's
    edge lanes: zero-length and one-row patterns, plen > Lp, an empty
    window, a window past Lt, an unreachable lane (plen > tlen + w, where
    Lp allows it), a GLOBAL goal outside the band; for GLOBAL most
    window lengths near the pattern's, so that the goal has a path."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 50_000).astype(np.int8)
    ws = rng.integers(0, len(genome) - lt - lp, nb)
    texts = genome[ws[:, None] + np.arange(lt)]
    off = rng.integers(0, min(band_w, lt) + 1, nb)
    pats = genome[(ws + off)[:, None] + np.arange(lp)]
    mut = rng.random(pats.shape) < 0.04
    pats[mut] = rng.integers(0, 5, int(mut.sum()))
    texts = texts.copy()
    texts[rng.random(texts.shape) < 0.01] = 4
    plens = rng.integers(max(lp * 3 // 4, 1), lp + 1, nb).astype(np.int32)
    tlens = rng.integers(lt // 2, lt + 1, nb).astype(np.int32)
    if atype == AlignmentType.GLOBAL:
        tlens = np.clip(plens + rng.integers(-band_w, band_w + 1, nb), 0,
                        lt).astype(np.int32)
    plens[0], plens[1], plens[2] = 0, min(lp, 1), lp + 5
    tlens[3], tlens[4] = 0, lt + 9
    plens[5] = lp
    tlens[5] = max(lp - band_w - 2, 0)  # unreachable where lp > w + 2
    tlens[6] = min(plens[6] + band_w + 3, 4 * lt)  # goal outside the band
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    return (pats.astype(np.int8), plens, texts.astype(np.int8), tlens,
            quals, ws.astype(np.int64), genome)


#: (Lp, band_w) of the sweep's cases: the first band past the group
#: kernel (129 cells), unreachable lanes (Lp > w + 2), one lane with
#: rows, ragged last lanes, the rescue's band, the widest band; 8 rows a
#: lane (Lp 129-256, the rescue's band on 150 bp mates at Lp 160)
_SWEEP_CASES = [(128, 64), (100, 65), (1, 70), (33, 100), (128, 530),
                (90, 971), (129, 64), (160, 530), (200, 150), (256, 971)]
#: scores past a signed byte on each
_SWEEP_RUNS = [(lp, w, big) for lp, w in _SWEEP_CASES
               for big in (False, True)]


@pytest.mark.parametrize(
    "lp,band_w,big", _SWEEP_RUNS,
    ids=[f"lp{a}_w{b}{'_big' if c else ''}" for a, b, c in _SWEEP_RUNS])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k4_sweep_matches_plain(cuda, atype, lp, band_w, big):
    """K4's column sweep (score-only past 128 cells at Lp <= 256: one
    warp an alignment, 4 rows a lane to Lp 128 and 8 past it, wide_plan)
    over symbol and packed windows, bit for bit against the plain
    version, at its edge lanes (_sweep_inputs), with scores in the byte
    table and past a signed byte; each call asserted to take the sweep,
    as the kernel library reports it."""
    assert long_dp.wide_plan(lp, band_w) == (
        long_dp.SWEEP, 4 if lp <= 128 else 8, long_dp.SWEEP_WARPS)
    lt = lp + 2 * band_w
    pats, plens, texts, tlens, quals, ws, genome = _sweep_inputs(
        lp * 7 + band_w, 64, lp, band_w, lt, atype)
    kw = dict(scheme=(BIG if big else SCHEMES)[atype], atype=atype,
              band_w=band_w)
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    dev = [a.to(cuda) for a in cpu]
    # packed windows end at the window, as the mapper's do
    ptl = np.minimum(tlens, lt)
    gw = banded_dp.pack_genome_words(genome)
    banded_dp.reset_launch_counts()
    got = banded_dp.banded_score(*dev, **kw)
    got3 = banded_dp.banded_score_packed(
        dev[0], dev[1], gw.to(cuda), torch.from_numpy(ws).to(cuda),
        torch.from_numpy(ptl).to(cuda), dev[4], **kw)
    torch.cuda.synchronize()
    assert long_dp.launch.launches == 2
    assert long_dp.launch.sweep_launches == 2
    want = banded_score_batch(*cpu, **kw)
    want3 = banded_dp.banded_score_packed(
        cpu[0], cpu[1], gw, torch.from_numpy(ws), torch.from_numpy(ptl),
        cpu[4], **kw)
    assert (want["score"] > -(1 << 29)).float().mean() > 0.5
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), ("symbols", k)
        assert torch.equal(got3[k].cpu(), want3[k]), ("packed", k)


#: (Lp, band_w) on each side of every edge of wide_plan: the group
#: kernel's widest band, the sweep at 4 and 8 rows a lane, the block
#: kernel past Lp 256 (through banded_score to Lp 512, banded_score_long
#: past it)
_TIER_CASES = [(128, 63), (128, 64), (129, 64), (256, 971), (257, 64),
               (512, 530), (2016, 200), (2048, 100)]


@pytest.mark.parametrize("lp,band_w", _TIER_CASES,
                         ids=[f"lp{a}_w{b}" for a, b in _TIER_CASES])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k4_score_tier_by_shape(cuda, atype, lp, band_w):
    """K4's score calls on either side of each edge of wide_plan, through
    the entry points the mapper calls (banded_score, and
    banded_score_long past Lp 512), bit for bit against the plain
    version; the tier the kernel library reports it launched (the sweep
    or not, launch.sweep_launches) is the one the Python plan gives."""
    tier = long_dp.wide_plan(lp, band_w)[0]
    pats, plens, texts, tlens, quals, _, _ = _sweep_inputs(
        band_w + lp, 40 if lp <= 512 else 12, lp, band_w, lp + 2 * band_w,
        atype)
    kw = dict(scheme=SCHEMES[atype], atype=atype, band_w=band_w)
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens, quals)]
    dev = [a.to(cuda) for a in cpu]
    entry = (banded_dp.banded_score if lp <= 512
             else long_dp.banded_score_long)
    banded_dp.reset_launch_counts()
    got = entry(*dev, **kw)
    torch.cuda.synchronize()
    assert long_dp.launch.launches == 1
    assert long_dp.launch.sweep_launches == int(tier == long_dp.SWEEP)
    want = banded_score_batch(*cpu, **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


#: every Lp and band_w of tests/test_torch_long_dp.py's WIDE_PLAN_TABLE,
#: and the band's reach on either side
_PLAN_LPS = (1, 128, 129, 160, 256, 257, 512, 600, 1025, 2016, 2049,
             10_000)
_PLAN_WS = (-1, 0, 63, 64, 100, 128, 512, 530, 971, 1023, 1024, 5000)


def test_k4_wide_plan_matches_python(cuda):
    """The C entry k4_wide_plan (the plan K4's score entries launch by)
    equals long_dp.wide_plan at every (Lp, band_w) of _PLAN_LPS x
    _PLAN_WS, and refuses the bands the Python plan raises on."""
    import ctypes

    from nvbio_tpu_torch.ops import _build

    lib = _build.library()
    for lp in _PLAN_LPS:
        for w in _PLAN_WS:
            plan = (ctypes.c_int * 3)()
            rc = lib.k4_wide_plan(lp, w, plan)
            try:
                want = long_dp.wide_plan(lp, w)
            except ValueError:
                assert rc != 0, (lp, w)
                continue
            assert rc == 0 and tuple(plan) == want, (lp, w, tuple(plan))


def test_k2_local_at_the_all_mappings_shape(cuda):
    """K2 in LOCAL at -a's traceback call (8 x 4 096 winners x 128 rows,
    band_w 15) against its plain version run on the card, flags and walks
    included."""
    genome = np.random.default_rng(4).integers(0, 4, 400_000).astype(np.int8)
    pats, plens, texts, tlens, quals, _ = _batch(11, 32_768, 128, 15, genome)
    kw = dict(scheme=GotohScheme(match=2), atype=AlignmentType.LOCAL,
              band_w=15)
    dev = [torch.from_numpy(a).to(cuda)
           for a in (pats, plens, texts, tlens, quals)]
    banded_dp.reset_launch_counts()
    r, d = banded_dp.banded_directions(*dev, **kw)
    wr, wd = banded_directions_batch(*dev, **kw)
    torch.cuda.synchronize()
    assert banded_dp.banded_directions.launches == 1
    for k in wr:
        assert torch.equal(r[k], wr[k]), k
    assert torch.equal(d, wd)
    for g, w in zip(_walk(r, d, 15), _walk(wr, wd, 15)):
        assert torch.equal(g, w)


def test_backtrack_on_cuda_equals_cpu(cuda):
    """hamming_backtrack_1 on the card's index tensors equals the same
    call on the CPU, every output; seeds with N, ragged lengths."""
    from nvbio_tpu_torch.fmindex.backtrack import hamming_backtrack_1
    from nvbio_tpu_torch.fmindex.build import build_fm_arrays
    from nvbio_tpu_torch.io.index_file import index_from_numpy

    rng = np.random.default_rng(12)
    text = rng.integers(0, 4, 50_000).astype(np.uint8)
    fm_np, ssa_np = build_fm_arrays(text, sa_sample=4)
    L, N = 22, 4_096
    starts = rng.integers(0, len(text) - L, N)
    seeds = text[starts[:, None] + np.arange(L)].astype(np.int64)
    sub = rng.random(seeds.shape) < 0.05
    seeds[sub] = (seeds[sub] + 1) % 4
    seeds[rng.random(seeds.shape) < 0.01] = 4
    slens = rng.integers(8, L + 1, N)
    out = {}
    for dev in ("cpu", cuda):
        fm, _, _, _ = index_from_numpy(fm_np, ssa_np, text, device=dev)
        out[str(dev)] = hamming_backtrack_1(
            fm, torch.from_numpy(seeds).to(dev),
            torch.from_numpy(slens).to(dev))
    for k, v in out["cpu"].items():
        assert torch.equal(out["cuda"][k].cpu(), v), k
    assert out["cpu"]["valid"].any()


@pytest.mark.parametrize("data,flags", [
    ("se", ["--local"]), ("se", ["-N", "1"]), ("se", ["-a", "--max-alns", "4"]),
    ("pe", ["--local"])], ids=["se-local", "se-N1", "se-all4", "pe-local"])
def test_mode_sam_on_cuda_equals_cpu(cuda, tmp_path, data, flags):
    """The golden datasets under --local, -N 1 and -a --max-alns 4 (PE:
    --local, whose rescue is K4 at band_w 530): --device cuda SAM equals
    --device cpu SAM; K2 and K3 launched (and K4 for PE)."""
    from test_torch_golden import write_golden_dataset

    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    if data == "se":
        write_golden_dataset(tmp_path)
        reads = ["-U", str(tmp_path / "r.fq")]
    else:
        _golden_pe(tmp_path)
        reads = ["-1", str(tmp_path / "r1.fq"), "-2", str(tmp_path / "r2.fq")]
    build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")])
    sams = {}
    for dev in ("cuda", "cpu"):
        banded_dp.reset_launch_counts()
        assert mapr(["-x", str(tmp_path / "g.npz"), *reads, "-S",
                     str(tmp_path / f"{dev}.sam"), "--device", dev,
                     "--batch", "128", *flags]) == 0
        if dev == "cuda":
            counts = {k: f.launches for k, f in banded_dp.KERNELS.items()}
            need = ("K2", "K3", "K4") if data == "pe" else ("K2", "K3")
            assert all(counts[k] > 0 for k in need), counts
        sams[dev] = [ln for ln in open(tmp_path / f"{dev}.sam")
                     if not ln.startswith("@PG")]
    assert sams["cuda"] == sams["cpu"]


def test_sharded_se_sam_on_cuda_equals_cpu(cuda, tmp_path):
    """build_index --shard-bp, then map_reads on the manifest: --device
    cuda SAM = --device cpu SAM on 256 reads over 3 shards, reads planted
    across both boundaries included; K2 and K3 launched."""
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads

    g = random_genome(150_000, seed=11)
    write_fasta(str(tmp_path / "g.fa"), [("c1", g[:90_000]),
                                          ("c2", g[90_000:])])
    sim = simulate_reads(g, 256, 100, error_rate=0.02, seed=12)
    seqs = [s.astype(np.uint8) for s in sim["seqs"]]
    for i, s0 in enumerate((59_950, 59_990, 119_950, 119_990)):
        seqs[i] = g[s0:s0 + 100].astype(np.uint8)
    write_fastq(str(tmp_path / "r.fq"), [
        (f"r{i}", seqs[i], sim["quals"][i]) for i in range(256)])
    assert build([str(tmp_path / "g.fa"), str(tmp_path / "g"),
                  "--shard-bp", "60000", "--shard-overlap", "2048",
                  "--lut-k", "8"]) == 0
    sams = {}
    for dev in ("cuda", "cpu"):
        banded_dp.reset_launch_counts()
        assert mapr(["-x", str(tmp_path / "g.manifest.json"), "-U",
                     str(tmp_path / "r.fq"), "-S",
                     str(tmp_path / f"{dev}.sam"), "--device", dev,
                     "--mesh", "off", "--batch", "128"]) == 0
        if dev == "cuda":
            counts = {k: f.launches for k, f in banded_dp.KERNELS.items()}
            assert counts["K2"] > 0 and counts["K3"] > 0, counts
        sams[dev] = [ln for ln in open(tmp_path / f"{dev}.sam")
                     if not ln.startswith("@PG")]
    assert sams["cuda"] == sams["cpu"]
    recs = [ln.split("\t") for ln in sams["cuda"] if not ln.startswith("@")]
    assert sum(not int(r[1]) & 4 for r in recs) > 240


def test_find_mems_on_cuda_equals_cpu(cuda):
    """fmindex.mem.find_mems (the MEM mapper's SMEM search): its four
    outputs on the card equal the CPU's, on both strands of 256 reads
    with Ns, ragged lengths and reads absent from the genome."""
    from nvbio_tpu_torch.fmindex.build import build_fm_arrays
    from nvbio_tpu_torch.fmindex.mem import find_mems
    from nvbio_tpu_torch.io.index_file import index_from_numpy
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads

    g = random_genome(200_000, seed=13)
    sim = simulate_reads(g, 256, 100, error_rate=0.02, seed=14)
    reads = np.full((256, 128), 7, np.int8)
    reads[:, :100] = sim["seqs"]
    reads[::7, 31] = 4
    reads[200:, :100] = np.random.default_rng(15).integers(0, 4, (56, 100))
    lens = np.full(256, 100, np.int64)
    lens[::5] = 77
    reads[::5, 77:] = 7
    fm_f, ssa_f = build_fm_arrays(g, sa_sample=4)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        fm, _, _, _ = index_from_numpy(fm_f, ssa_f, g, device=dev)
        got[dev.type] = find_mems(fm, torch.from_numpy(reads).to(dev),
                                  torch.from_numpy(lens).to(dev), 128, 19)
    for k in got["cpu"]:
        assert torch.equal(got["cuda"][k].cpu(), got["cpu"][k]), k
    assert int(got["cpu"]["smem"].sum()) > 150


@pytest.mark.parametrize("tool,flags", [("mem_map", []),
                                        ("mem_map", ["--local"]),
                                        ("qmap", []),
                                        ("qmap", ["-q", "12", "--stride",
                                                  "5"])],
                         ids=["mem", "mem-local", "qmap", "qmap-q12"])
def test_seed_mapper_sam_on_cuda_equals_cpu(cuda, tmp_path, tool, flags):
    """mem_map and qmap on the golden single-end dataset: --device cuda
    SAM = --device cpu SAM, K2 and K3 launched on the card."""
    import importlib

    from test_torch_golden import write_golden_dataset

    from nvbio_tpu_torch.tools.build_index import main as build

    main = importlib.import_module(f"nvbio_tpu_torch.tools.{tool}").main
    write_golden_dataset(tmp_path)
    build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")])
    sams = {}
    for dev in ("cuda", "cpu"):
        banded_dp.reset_launch_counts()
        assert main(["-x", str(tmp_path / "g.npz"), "-U",
                     str(tmp_path / "r.fq"), "-S",
                     str(tmp_path / f"{dev}.sam"), "--device", dev,
                     "--batch", "128", *flags]) == 0
        if dev == "cuda":
            counts = {k: f.launches for k, f in banded_dp.KERNELS.items()}
            assert counts["K2"] > 0 and counts["K3"] > 0, counts
        sams[dev] = [ln for ln in open(tmp_path / f"{dev}.sam")
                     if not ln.startswith("@PG")]
    assert sams["cuda"] == sams["cpu"]
    recs = [ln.split("\t") for ln in sams["cuda"] if not ln.startswith("@")]
    assert sum(not int(r[1]) & 4 for r in recs) > 270


def _sufsort_texts():
    """A random text, a tandem + homopolymer one, and a repeat-structured
    genome (which reaches the bucketed sort's compacted doubling)."""
    from nvbio_tpu_torch.utils.simulate import repeat_structured_genome

    rng = np.random.default_rng(90)
    unit = rng.integers(0, 4, 7).astype(np.uint8)
    return {"random": rng.integers(0, 4, 200_000).astype(np.uint8),
            "tandem": np.concatenate([
                np.tile(unit, 4000), np.zeros(5000, np.uint8),
                rng.integers(0, 4, 10_000).astype(np.uint8)]),
            "repeats": repeat_structured_genome(400_000, seed=7)[0]}


@pytest.mark.parametrize("name", ["random", "tandem", "repeats"])
def test_suffix_sorts_on_cuda_equal_cpu(cuda, name, capsys):
    """suffix_array_device and suffix_array_bucketed (chunk_cap 1 << 16)
    on cuda = on cpu = SA-IS."""
    from nvbio_tpu_torch.sufsort import (suffix_array, suffix_array_bucketed,
                                         suffix_array_device)

    t = _sufsort_texts()[name]
    want = suffix_array(t)
    for dev in ("cuda", "cpu"):
        np.testing.assert_array_equal(suffix_array_device(t, dev), want)
        np.testing.assert_array_equal(
            suffix_array_bucketed(t, chunk_cap=1 << 16, verbose=True,
                                  device=dev), want)
    if name == "repeats":
        assert "[sufsort] doubling k=64" in capsys.readouterr().out


def test_set_bwt_on_cuda_equals_cpu(cuda):
    from nvbio_tpu_torch.sufsort import set_bwt_device, set_bwt_oracle

    rng = np.random.default_rng(91)
    reads = rng.integers(0, 4, (5000, 100)).astype(np.uint8)
    lens = rng.integers(1, 101, 5000).astype(np.int32)
    reads[4000:] = reads[0]  # duplicate reads: the read-id tie-break
    lens[4000:] = 100
    got = set_bwt_device(reads, lens, "cuda")
    np.testing.assert_array_equal(got, set_bwt_device(reads, lens, "cpu"))
    np.testing.assert_array_equal(
        set_bwt_device(reads[:40], lens[:40], "cuda"),
        set_bwt_oracle(reads[:40], lens[:40]))
    assert np.array_equal(np.bincount(got, minlength=5)[4:], [5000])


def test_occ_tables_on_cuda_equal_cpu(cuda, monkeypatch):
    """occ_tables_device on cuda = on cpu = the host tables, with 4 096-
    block chunks (the carry crosses chunks)."""
    from nvbio_tpu_torch.basic.packed import pack_2bit
    from nvbio_tpu_torch.fmindex import build

    monkeypatch.setattr(build, "OCC_CHUNK_BLOCKS", 1 << 12)
    g = np.random.default_rng(92).integers(0, 4, 2_000_000).astype(np.uint8)
    bwt, _ = build.bwt_from_sa(g, build.suffix_array(g))
    m = len(g) + 1
    n_blocks = (m + build.BLOCK - 1) // build.BLOCK + 1
    bwt_pad = np.zeros(n_blocks * build.BLOCK, np.uint8)
    bwt_pad[:m] = bwt
    words = pack_2bit(bwt_pad).reshape(n_blocks, build.WORDS)
    got = build.occ_tables_device(words, "cuda")
    for a, b, c in zip(got, build.occ_tables_device(words, "cpu"),
                       build._occ_tables_host(bwt_pad, n_blocks)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _protein_pairs(seed, nb, lq, lt):
    """Random 20-letter proteins, every other text holding a ~30 %
    substituted copy of its query; X and '*' codes, ragged lengths and
    a zero-length query."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(0, 20, (nb, lq)).astype(np.int8)
    texts = rng.integers(0, 20, (nb, lt)).astype(np.int8)
    plens = rng.integers(lq // 2, lq + 1, nb).astype(np.int32)
    tlens = rng.integers(lt // 2, lt + 1, nb).astype(np.int32)
    for b in range(0, nb, 2):
        m = int(min(plens[b], tlens[b]))
        s = int(rng.integers(0, tlens[b] - m + 1))
        seg = pats[b, :m].copy()
        sub = rng.random(m) < 0.3
        seg[sub] = rng.integers(0, 20, int(sub.sum()))
        texts[b, s:s + m] = seg
    pats[1, min(3, lq - 1)], texts[2, min(4, lt - 1)], plens[3] = 20, 21, 0
    return pats, plens, texts, tlens


# the full-band tier's edges: a lane's rows (wavefront_dp.FULL_RPL), a
# pass's 32 lanes, two passes and a ragged third, against texts of one
# column, a few and many
_RPL = 8  # wavefront_dp.FULL_RPL, checked in the test
_FULL_EDGES = [(lq, lt) for lq in (1, 31, 32, 33, 32 * _RPL, 32 * _RPL + 1,
                                   2 * 32 * _RPL + 5)
               for lt in (1, 40, 700)]


@pytest.mark.parametrize(
    "lq,lt", [(60, 90), (120, 70), (2100, 4200)] + _FULL_EDGES,
    ids=["smem", "smem-lq>lt", "scratch"]
    + [f"lq{lq}-lt{lt}" for lq, lt in _FULL_EDGES])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_matrix_matches_plain(cuda, atype, lq, lt):
    """K5's matrix mode at band_w = max(Lq, Lt), as full_score_batch
    calls it, against the twin's matrix gather: the full-band tier takes
    every such call (2100 x 4200 in 9 passes of 256 rows)."""
    from nvbio_tpu_torch.alignment.blosum import MatrixScheme
    from nvbio_tpu_torch.alignment.extra import full_score_batch
    from nvbio_tpu_torch.ops import wavefront_dp

    assert wavefront_dp.FULL_RPL == _RPL
    cpu = [torch.from_numpy(a) for a in _protein_pairs(lq + lt, 6, lq, lt)]
    kw = dict(scheme=MatrixScheme(gap_open=10, gap_extend=1), atype=atype)
    banded_dp.reset_launch_counts()
    got = full_score_batch(*[a.to(cuda) for a in cpu], **kw)
    torch.cuda.synchronize()
    assert wavefront_dp.wavefront_score_matrix.launches == 1
    assert wavefront_dp.wavefront_score_matrix.full_launches == 1
    assert wavefront_dp.wavefront_score.launches == 0
    want = full_score_batch(*cpu, **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    with pytest.raises(ValueError, match="no substitution matrix"):
        wavefront_dp.wavefront_dirs(*[a.to(cuda) for a in cpu],
                                    band_w=max(lq, lt), **kw)


def _k5_matrix_on_card(cuda, cpu, scheme, atype, band_w):
    """wavefront_score_matrix on the card = its plain version on the CPU;
    returns (launches, full-band launches) of the card's call."""
    from nvbio_tpu_torch.ops import wavefront_dp

    kw = dict(scheme=scheme, atype=atype, band_w=band_w)
    banded_dp.reset_launch_counts()
    got = wavefront_dp.wavefront_score_matrix(*[a.to(cuda) for a in cpu],
                                              **kw)
    torch.cuda.synchronize()
    counts = (wavefront_dp.wavefront_score_matrix.launches,
              wavefront_dp.wavefront_score_matrix.full_launches)
    want = wavefront_dp.wavefront_score_matrix(*cpu, **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    return counts


@pytest.mark.parametrize("kind", ["repeats", "clipped", "empty"])
@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_matrix_full_band_edge_cases(cuda, atype, kind):
    """The full-band tier on tests/_k5_matrix_cases' pairs (ties, clipped
    symbols, zero lengths), which tests/test_torch_protein.py holds the
    plain version to the JAX twin on."""
    from nvbio_tpu_torch.alignment.blosum import MatrixScheme

    import _k5_matrix_cases as k5_cases

    cpu = [torch.from_numpy(a) for a in k5_cases.pairs(kind)]
    band_w = max(k5_cases.LQ, k5_cases.LT)
    assert _k5_matrix_on_card(cuda, cpu, MatrixScheme(), atype,
                              band_w) == (1, 1)


@pytest.mark.parametrize("atype", list(AlignmentType),
                         ids=[a.name.lower() for a in AlignmentType])
def test_k5_matrix_small_table_and_banded_call(cuda, atype):
    """A random K = 4 table (symbols clipped to 0..3) through the
    full-band tier at 2 passes + 5 rows, tlens past Lt on some lanes (the
    band's upper edge then binds); and a banded matrix call (band_w <
    max(Lp, Lt)), which stays on the diagonal kernel."""
    from nvbio_tpu_torch.alignment.blosum import MatrixScheme

    rng = np.random.default_rng(41)
    table = rng.integers(-5, 6, (4, 4))
    scheme = MatrixScheme(matrix=tuple(tuple(int(v) for v in row)
                                       for row in table), gap_open=3,
                          gap_extend=1)
    lq, lt, nb = 2 * 32 * _RPL + 5, 200, 12
    pats = rng.integers(-2, 7, (nb, lq)).astype(np.int8)
    texts = rng.integers(-2, 7, (nb, lt)).astype(np.int8)
    texts[::2, 20:180] = pats[::2, 40:200]
    plens = rng.integers(1, lq + 1, nb).astype(np.int32)
    tlens = rng.integers(1, lt + 1, nb).astype(np.int32)
    plens[0], tlens[1] = lq, lt
    tlens[2], tlens[3] = lt + 30, 3 * lq  # past Lt; past band_w on lane 3
    cpu = [torch.from_numpy(a) for a in (pats, plens, texts, tlens)]
    assert _k5_matrix_on_card(cuda, cpu, scheme, atype, lq) == (1, 1)
    short = [a[:, :60] if a.dim() == 2 else a.clamp(max=60) for a in cpu]
    assert _k5_matrix_on_card(cuda, short, scheme, atype, 20) == (1, 0)


def test_protein_sw_and_wavelet_search_on_cuda_equal_cpu(cuda, tmp_path):
    from nvbio_tpu_torch.basic.alphabet import decode_protein
    from nvbio_tpu_torch.fmindex.wavelet_fm import (build_wavelet_fm_index,
                                                    wfm_backward_search)
    from nvbio_tpu_torch.ops import wavefront_dp
    from nvbio_tpu_torch.tools.protein_sw import main

    rng = np.random.default_rng(95)
    q = [decode_protein(rng.integers(0, 20, int(rng.integers(20, 200))))
         for _ in range(6)]
    t = [decode_protein(rng.integers(0, 20, int(rng.integers(20, 300))))
         for _ in range(9)]
    t[4] = "GGG" + q[2] + "WW"
    (tmp_path / "q.fa").write_text("".join(f">q{i}\n{s}\n"
                                           for i, s in enumerate(q)))
    (tmp_path / "t.fa").write_text("".join(f">t{i}\n{s}\n"
                                           for i, s in enumerate(t)))
    out = {}
    for dev in ("cuda", "cpu"):
        banded_dp.reset_launch_counts()
        assert main([str(tmp_path / "q.fa"), str(tmp_path / "t.fa"), "-o",
                     str(tmp_path / f"{dev}.tsv"), "--device", dev]) == 0
        assert wavefront_dp.wavefront_score_matrix.launches == (
            dev == "cuda")
        out[dev] = (tmp_path / f"{dev}.tsv").read_bytes()
    assert out["cuda"] == out["cpu"]

    text = rng.integers(0, 20, 300_000).astype(np.uint8)
    starts = rng.integers(0, len(text) - 8, 2000)
    seeds = np.stack([text[s:s + 8] for s in starts]).astype(np.int32)
    seeds[::7, 3] = 21  # absent
    got = {}
    for dev in ("cuda", "cpu"):
        fm = build_wavelet_fm_index(text, 22, device=dev)
        lo, hi = wfm_backward_search(fm, torch.from_numpy(seeds).to(dev))
        got[dev] = (lo.cpu(), hi.cpu())
    assert all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"]))
    assert int((got["cpu"][1] > got["cpu"][0]).sum()) == 2000 - 286


def test_correct_reads_on_cuda_equals_cpu(cuda, tmp_path):
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.tools.correct_reads import main
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads

    g = random_genome(15_000, seed=96)
    sim = simulate_reads(g, 4000, 100, error_rate=0.01, indel_rate=0.0,
                         seed=97)
    write_fastq(str(tmp_path / "r.fq"), [
        (f"r{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(4000)])
    got = {}
    for dev in ("cuda", "cpu"):
        assert main([str(tmp_path / "r.fq"), str(tmp_path / f"{dev}.fq"),
                     "--log2-slots", "20", "--rounds", "2", "--batch",
                     "1500", "--device", dev]) == 0
        got[dev] = (tmp_path / f"{dev}.fq").read_bytes()
    assert got["cuda"] == got["cpu"]
    assert got["cpu"] != (tmp_path / "r.fq").read_bytes()


def test_self_test_on_cuda(cuda, capsys):
    """self_test --device cuda: all five checks, K1 against its plain
    version among them; the native CIGAR/MD builder, not the fallback,
    finishes its reads."""
    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.tools.self_test import main

    native = []
    real = M.ops_batch_native

    def counted(*a, **k):
        out = real(*a, **k)
        native.append(out is not None)
        return out

    M.ops_batch_native = counted
    try:
        assert main(["--quick", "--device", "cuda"]) == 0
    finally:
        M.ops_batch_native = real
    err = capsys.readouterr().err
    assert "K1 == its plain version" in err and "FAIL" not in err
    assert native and all(native)


def _mesh_setup():
    from nvbio_tpu_torch.fmindex.sharded import build_sharded_index
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads

    g = random_genome(180_000, seed=31)
    sim = simulate_reads(g, 96, 100, seed=32, error_rate=0.02)
    return (g, build_sharded_index(g, shard_bp=60_000, overlap=2048,
                                   sa_sample=16, lut_k=8),
            (sim["seqs"].astype(np.uint8), np.full(96, 100, np.int32),
             sim["quals"]))


def test_mesh_on_one_card_equals_sequential(cuda):
    """MeshShardedMapper with every shard on cuda:0 (3 shards) gives the
    sequential ShardedMapper's results, SE, PE and -a."""
    from dataclasses import asdict

    from nvbio_tpu_torch.models.mesh_sharded import (
        MeshPairedShardedMapper, MeshShardedMapper)
    from nvbio_tpu_torch.models.params import MapperParams
    from nvbio_tpu_torch.models.sharded_mapper import (PairedShardedMapper,
                                                       ShardedMapper)
    from nvbio_tpu_torch.parallel.mesh import to_device
    from nvbio_tpu_torch.utils.simulate import simulate_pairs

    g, sidx, reads = _mesh_setup()
    on_card = type(sidx)([(*to_device(s[:3], cuda), *s[3:])
                          for s in sidx.shards], sidx.n_total,
                         sidx.sa_sample, sidx.lut_k)
    p = MapperParams(batch_size=96, sa_sample=16, max_candidates=8, lut_k=8,
                     maxins=400)
    seq = ShardedMapper(on_card, g, params=p)
    mesh = MeshShardedMapper(sidx, g, params=p, devices=[cuda] * 3)
    assert [asdict(r) for r in mesh.map_reads(*reads)] == \
           [asdict(r) for r in seq.map_reads(*reads)]
    assert [[asdict(a) for a in xs] for xs in mesh.map_reads_all(*reads, 4)] \
        == [[asdict(a) for a in xs] for xs in seq.map_reads_all(*reads, 4)]
    pe = simulate_pairs(g, 96, 100, insert_mean=250, insert_sd=25, seed=12)
    lens = np.full(96, 100, np.int32)
    args = (pe["seqs1"].astype(np.uint8), lens, pe["quals1"],
            pe["seqs2"].astype(np.uint8), lens, pe["quals2"])
    got = MeshPairedShardedMapper(sidx, g, params=p,
                                  devices=[cuda] * 3).map_pairs(*args)
    want = PairedShardedMapper(on_card, g, params=p).map_pairs(*args)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert [asdict(r) for r in a] == [asdict(r) for r in b]


def test_fm_server_on_cuda_equals_cpu(cuda, tmp_path):
    """fm_server serving on cuda writes the CPU server's SE and PE SAM."""
    import tempfile
    import threading
    import time

    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.tools import fm_server
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_pairs

    g = random_genome(120_000, seed=61)
    write_fasta(str(tmp_path / "g.fa"), [("chr1", g)])
    pe = simulate_pairs(g, 256, 100, insert_mean=280, insert_sd=25,
                        error_rate=0.02, seed=62)
    for m in (1, 2):
        write_fastq(str(tmp_path / f"p{m}.fq"), [
            (f"p{i}", pe[f"seqs{m}"][i].astype(np.uint8), pe[f"quals{m}"][i])
            for i in range(256)])
    assert build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")]) == 0
    sams = {}
    for dev in ("cuda", "cpu"):
        sock = os.path.join(tempfile.mkdtemp(), "fm.sock")
        t = threading.Thread(target=fm_server.serve,
                             args=(str(tmp_path / "g.npz"), sock),
                             kwargs=dict(batch=128, device=dev), daemon=True)
        t.start()
        while not os.path.exists(sock):
            assert t.is_alive(), f"the {dev} server stopped before serving"
            time.sleep(0.1)
        for tag, req in (("se", {"u": str(tmp_path / "p1.fq")}),
                         ("pe", {"m1": str(tmp_path / "p1.fq"),
                                 "m2": str(tmp_path / "p2.fq")})):
            out = str(tmp_path / f"{dev}_{tag}.sam")
            r = fm_server.request(sock, {"cmd": "map", **req, "sam": out})
            assert r["status"] == "ok", r
            sams[dev, tag] = [ln for ln in open(out)
                              if not ln.startswith("@PG")]
        fm_server.request(sock, {"cmd": "stop"})
        t.join(timeout=60)
    for tag in ("se", "pe"):
        assert sams["cuda", tag] == sams["cpu", tag]
        assert sum(not int(ln.split("\t")[1]) & 4 for ln in sams["cuda", tag]
                   if not ln.startswith("@")) > 0.9 * len(sams["cuda", tag])
