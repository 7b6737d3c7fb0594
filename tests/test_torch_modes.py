"""The port's remaining alignment modes against the JAX package on the
CPU, exact equality throughout: map_reads --device cpu SAM equal to
nvbio_tpu.tools.map_reads --cpu SAM (@PG masked) for single-end --local,
-N 1 and -a --max-alns 4 on the golden SE dataset and for paired-end
--local and -N 1 on the golden PE dataset; pe_map_batch in LOCAL mode,
field by field, on pairs that need the window-wide LOCAL rescue; the
port's counterparts of tests/test_mapper.py's planted -N 1 and -a checks;
and the effort-escalation ladder of tests/test_escalation_ladder.py at
max_effort 2 and 3."""

import numpy as np
import pytest
import torch

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.models import paired as jax_paired
from nvbio_tpu.models.mapper import Mapper as JaxMapper
from nvbio_tpu.models.params import MapperParams as JaxParams
from nvbio_tpu.utils.simulate import random_genome, simulate_pairs
from nvbio_tpu_torch.io.index_file import index_from_numpy
from nvbio_tpu_torch.models import paired
from nvbio_tpu_torch.models.mapper import Mapper
from nvbio_tpu_torch.models.params import MapperParams
from nvbio_tpu_torch.strings.string_set import pack_reads
from test_torch_bam import _write_pe, _write_se


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as the other port tests (the plain DP's
    small per-row ops slow down when the workers' pools fight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden SE and PE datasets, each with an index built by the
    port."""
    from nvbio_tpu_torch.tools.build_index import main as build

    out = {}
    for name, write in (("se", _write_se), ("pe", _write_pe)):
        d = tmp_path_factory.mktemp(name)
        reads = write(d)
        assert build([str(d / "g.fa"), str(d / "g.npz")]) == 0
        out[name] = (d, reads)
    return out


def _sam(path):
    return [ln for ln in open(path) if not ln.startswith("@PG")]


MODES = [("se", ["--local"]), ("se", ["-N", "1"]),
         ("se", ["-a", "--max-alns", "4"]), ("pe", ["--local"]),
         ("pe", ["-N", "1"])]


@pytest.mark.parametrize("data,flags", MODES,
                         ids=["se-local", "se-N1", "se-all4", "pe-local",
                              "pe-N1"])
def test_mode_sam_equals_reference(golden, data, flags):
    from nvbio_tpu.tools.map_reads import main as ref_map
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    d, reads = golden[data]
    common = ["-x", str(d / "g.npz"), *reads, "--batch", "128", *flags]
    assert port_map([*common, "-S", str(d / "port.sam"),
                     "--device", "cpu"]) == 0
    ref_map([*common, "-S", str(d / "ref.sam"), "--cpu"])
    got, want = _sam(d / "port.sam"), _sam(d / "ref.sam")
    assert got == want
    recs = [ln.split("\t") for ln in got if not ln.startswith("@")]
    aligned = [r for r in recs if not int(r[1]) & 4]
    assert len(aligned) > 0.9 * len(recs)
    if "--local" in flags:
        assert any("S" in r[5] for r in aligned)  # soft clips
    if "-a" in flags:
        assert any(int(r[1]) & 0x100 for r in aligned)  # secondaries


def _mappers(g, sa_sample, **kw):
    fm, ssa = build_fm_index(g, sa_sample=sa_sample, bi_sample=True)
    tfm, tssa, tg, _ = index_from_numpy(
        [np.asarray(x) for x in fm[:6]], [np.asarray(x) for x in ssa], g)
    return fm, ssa, tfm, tssa, tg


def test_pe_map_batch_local_rescue_matches_jax():
    """pe_map_batch with local=True, every field equal to the JAX
    function's; half the mate-2 reads have every 12th base flipped so
    that the window-wide LOCAL rescue (band_w = maxins + 2W) places
    them."""
    R, L = 64, 80
    g = random_genome(80_000, seed=17)
    kw = dict(batch_size=R, max_candidates=8, minins=0, maxins=400,
              local=True, score_min_fn="G", score_min_a=20.0,
              score_min_b=8.0)
    fm, ssa, tfm, tssa, tg = _mappers(g, 16)
    from nvbio_tpu.alignment.types import GotohScheme as JaxScheme
    from nvbio_tpu_torch.alignment.types import GotohScheme

    jm = jax_paired.PairedMapper(fm, ssa, g, params=JaxParams(
        sa_sample=16, scheme=JaxScheme(match=2), **kw), use_pallas=False)
    tm = paired.PairedMapper(tfm, tssa, tg, params=MapperParams(
        sa_sample=16, scheme=GotohScheme(match=2), **kw))
    sim = simulate_pairs(g, R, L, insert_mean=200, insert_sd=10,
                         error_rate=0.0, seed=8)
    s2 = sim["seqs2"].copy()
    for k in range(4, L, 12):
        s2[::2, k] = (s2[::2, k] + 1) % 4
    lens = np.full(R, L, np.int32)
    lens[7] = 60
    args = (sim["seqs1"], lens, sim["quals1"], s2, lens, sim["quals2"])
    _, _, jargs = jm._stage_pair_batch(*args)
    want = jax_paired.pe_map_batch(
        jm.fm, jm.ssa, jm.genome, *jargs, params=jm._chunk_params(L, 60),
        use_pallas=False, lut=jm.lut, gwords=jm.gwords, fm2=jm.fm2,
        bi=jm.bi)
    _, tensors = tm._stage_pair_batch(*args)
    got = paired.pe_map_batch(tm.fm, tm.ssa, tm.gwords, tm.genome,
                              *tensors[0], *tensors[1],
                              params=tm._chunk_params(L, 60), lut=tm.lut)
    for w, gt in zip(want, got):
        assert set(gt) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(gt[k]), np.asarray(w[k]),
                                          err_msg=k)
    assert int(np.asarray(want[1]["resc"]).sum()) >= R // 4


def _planted_one_mismatch_seeds():
    """tests/test_mapper.py:140's reads: one substitution inside each of
    the two 16 bp seeds of every 32 bp read."""
    genome = random_genome(50_000, seed=77)
    rng = np.random.default_rng(78)
    R, L = 24, 32
    seqs, starts = [], []
    for _ in range(R):
        s = int(rng.integers(0, len(genome) - L))
        frag = genome[s : s + L].copy()
        for p in (8, 24):
            frag[p] = (frag[p] + 1 + rng.integers(0, 3)) % 4
        seqs.append(frag)
        starts.append(s)
    reads, lens, quals, _ = pack_reads(seqs, [np.full(L, 35, np.uint8)] * R)
    return genome, reads, lens, quals, starts


def _fields(results):
    return [(r.aligned, r.pos, r.strand, r.score, r.cigar, r.md, r.mapq)
            for r in results]


def test_one_mismatch_seeding_rescues_unseedable_reads():
    """-N 0 aligns none of the planted reads, -N 1 places all but at most
    two at their origin, and both equal the reference's results."""
    genome, reads, lens, quals, starts = _planted_one_mismatch_seeds()
    R = len(starts)
    common = dict(batch_size=R, sa_sample=16, max_candidates=8,
                  seed_len=16, seed_interval=16)
    fm, ssa, tfm, tssa, tg = _mappers(genome, 16)
    got = {}
    for mm in (0, 1):
        m = Mapper(tfm, tssa, tg,
                   params=MapperParams(seed_mismatches=mm, **common))
        got[mm] = m.map_reads(reads, lens, quals)
    assert sum(r.aligned for r in got[0]) == 0
    assert sum(r.aligned and r.pos == starts[i]
               for i, r in enumerate(got[1])) >= R - 2
    jm = JaxMapper(fm, ssa, genome,
                   params=JaxParams(seed_mismatches=1, **common),
                   use_pallas=False)
    want = jm.map_reads(reads, lens, quals.astype(np.int32))
    assert _fields(got[1]) == _fields(want)


def test_all_mappings_mode_finds_planted_duplicates():
    """-a (tests/test_mapper.py:183): a read whose origin was copied to a
    second locus reports both; one primary record a read plus FLAG 0x100
    secondaries; the alignments equal the reference's."""
    genome = random_genome(40_000, seed=55)
    genome[30_000:30_200] = genome[5_000:5_200]
    rng = np.random.default_rng(56)
    R, L = 16, 80
    seqs, starts = [], []
    for _ in range(R):
        off = int(rng.integers(0, 120))
        seqs.append(genome[5_000 + off : 5_000 + off + L].copy())
        starts.append(5_000 + off)
    reads, lens, quals, _ = pack_reads(seqs, [np.full(L, 35, np.uint8)] * R)
    fm, ssa, tfm, tssa, tg = _mappers(genome, 16)
    params = dict(batch_size=R, sa_sample=16, max_candidates=8)
    m = Mapper(tfm, tssa, tg, params=MapperParams(**params))
    all_res = m.map_reads_all(reads, lens, quals)
    for i, alns in enumerate(all_res):
        poss = sorted(a.pos for a in alns)
        assert len(alns) >= 2, (i, poss)
        assert starts[i] in poss and starts[i] + 25_000 in poss
    names = [f"r{i}" for i in range(R)]
    recs = m.to_sam_records_all(names, reads, lens, quals, all_res)
    assert sum(1 for r in recs if not r.flag & 0x104) == R
    assert sum(1 for r in recs if r.flag & 0x100) >= R
    jm = JaxMapper(fm, ssa, genome, params=JaxParams(**params),
                   use_pallas=False)
    want = jm.map_reads_all(reads, lens, quals.astype(np.int32))
    assert [_fields(a) for a in all_res] == [_fields(a) for a in want]
    assert [r.to_line() for r in recs] == [
        r.to_line() for r in jm.to_sam_records_all(names, reads, lens,
                                                   quals, want)]


def test_max_alns_must_be_positive(capsys):
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    with pytest.raises(SystemExit):
        port_map(["-x", "x.npz", "-U", "r.fq", "-S", "o.sam", "-a",
                  "--max-alns", "0", "--device", "cpu"])
    assert "--max-alns" in capsys.readouterr().err


@pytest.mark.parametrize("max_effort", [2, 3])
def test_escalation_ladder_matches_jax(max_effort):
    """tests/test_escalation_ladder.py:34's repeat genome (a 200 bp
    element in 100 copies) at max_range 4: max_effort 2 loses the reads
    and max_effort 3 recovers them; the MapResults, escalated and
    overflowed equal the reference's."""
    from test_escalation_ladder import _repeat_genome

    genome, element = _repeat_genome(copies=100)
    reads = [element[40:140].copy() for _ in range(4)]
    packed, lens, quals, _ = pack_reads(
        reads, [np.full(100, 35, np.uint8)] * 4, max_len=128)
    base = dict(batch_size=4, sa_sample=8, max_candidates=8, max_range=4,
                max_effort=max_effort)
    fm, ssa, tfm, tssa, tg = _mappers(genome, 8)
    m = Mapper(tfm, tssa, tg, params=MapperParams(**base))
    got = m.map_reads(packed, lens, quals)
    jm = JaxMapper(fm, ssa, genome, params=JaxParams(**base),
                   use_pallas=False)
    want = jm.map_reads(packed, lens, quals.astype(np.int32))
    assert _fields(got) == _fields(want)
    assert (m.escalated, m.overflowed) == (jm.escalated, jm.overflowed)
    assert all(r.aligned == (max_effort == 3) for r in got)
    assert m.escalated == 4 * (max_effort - 1) and m.overflowed == 4
