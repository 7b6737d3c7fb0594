"""The MEM ("nvMem") mapper of the port against the JAX package on the
CPU, exact equality throughout: ``find_mems``' four outputs at two
(max_len, min_len) settings, every key of ``mem_map_batch``'s output,
``MemMapper.map_reads``' MapResults and counters, and the ``mem_map``
CLI's SAM (@PG masked) on the golden single-end dataset, default,
--local, -k 25 --max-smems 4 and -S *.bam.  The tie reads hold three
SMEMs of one length (pieces of the genome joined by N) and keep two
(--max-smems 2): which two survive is the stable top-K's choice."""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.fmindex.mem import find_mems as jax_find_mems
from nvbio_tpu.models.mem_mapper import MemMapper as JaxMemMapper
from nvbio_tpu.models.params import MapperParams as JaxParams
from nvbio_tpu.utils.simulate import random_genome, simulate_reads
from nvbio_tpu_torch.fmindex.mem import find_mems
from nvbio_tpu_torch.models.mem_mapper import MemMapper
from nvbio_tpu_torch.models.params import MapperParams
from nvbio_tpu_torch.strings.string_set import pack_reads
from test_torch_bam import _masked, _write_se
from test_torch_modes import _mappers


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as the other port tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    """An 80 kb genome with a 300 bp segment copied 12 times (repeated
    SA ranges), its JAX index and the port's copy of it."""
    g = random_genome(80_000, seed=21)
    for k in range(12):
        g[50_000 + 400 * k: 50_300 + 400 * k] = g[10_000:10_300]
    return (g, *_mappers(g, 16))


def _tie_reads(g, n):
    """Reads of three 25 bp pieces of the genome and a 22 bp one, joined
    by N: four SMEMs, three of them of length 25."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        s = rng.integers(0, 40_000, 4)
        out.append(np.concatenate([g[s[0]:s[0] + 25], [4], g[s[1]:s[1] + 25],
                                   [4], g[s[2]:s[2] + 25], [4],
                                   g[s[3]:s[3] + 22]]).astype(np.uint8))
    return out


def _reads(g, n_sim=48):
    """Simulated reads (2 % errors, indels; some from the repeat), tie
    reads, random reads and a short read, packed to 128 columns."""
    sim = simulate_reads(g, n_sim, 100, seed=6, error_rate=0.02,
                         indel_rate=0.005)
    seqs = [s.astype(np.uint8) for s in sim["seqs"]]
    seqs[:4] = [g[10_000 + 40 * k: 10_100 + 40 * k].astype(np.uint8)
                for k in range(4)]
    rng = np.random.default_rng(7)
    seqs += _tie_reads(g, 8)
    seqs += [rng.integers(0, 4, 100).astype(np.uint8) for _ in range(4)]
    seqs.append(g[20_000:20_060].astype(np.uint8))
    quals = [np.full(len(s), 30, np.uint8) for s in seqs]
    reads, lens, q, _ = pack_reads(seqs, quals, max_len=128)
    return reads, lens, q


@pytest.mark.parametrize("max_len,min_len", [(128, 19), (20, 12)],
                         ids=["full", "capped"])
def test_find_mems_matches_jax(index, max_len, min_len):
    g, fm, _, tfm, _, _ = index
    reads, lens, _ = _reads(g)
    want = jax_find_mems(fm, jnp.asarray(reads), jnp.asarray(lens),
                         max_len=max_len, min_len=min_len)
    got = find_mems(tfm, torch.from_numpy(reads),
                    torch.from_numpy(lens.astype(np.int64)), max_len,
                    min_len)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert np.asarray(want["smem"]).sum() > 60


def _mappers_of(index, **kw):
    g, fm, ssa, tfm, tssa, tg = index
    jm = JaxMemMapper(fm, ssa, g, params=JaxParams(**kw), use_pallas=False)
    tm = MemMapper(tfm, tssa, tg, params=MapperParams(**kw))
    return jm, tm


PARAMS = {"default": dict(batch_size=64, sa_sample=16),
          "ties": dict(batch_size=64, sa_sample=16, max_smems=2,
                       max_hits_per_seed=8, min_mem_len=15),
          "local": dict(batch_size=64, sa_sample=16, local=True,
                        max_candidates=8)}


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_mem_map_batch_matches_jax(index, name):
    jm, tm = _mappers_of(index, **PARAMS[name])
    reads, lens, quals = _reads(index[0])
    reads, lens, quals = tm._pad_chunk(reads, lens, quals)
    want = jm._forward(jnp.asarray(reads), jnp.asarray(lens.astype(np.int32)),
                       jnp.asarray(quals.astype(np.uint8)))
    got = tm._forward(*tm._upload(reads, lens, quals))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert np.asarray(want["aligned"]).sum() > 40


def _fields(results):
    return [(r.aligned, r.pos, r.strand, r.score, r.second, r.mapq, r.cigar,
             r.md, r.nm, r.ref_span) for r in results]


@pytest.mark.parametrize("name", ["default", "ties"])
def test_mem_mapper_map_reads_matches_jax(index, name):
    kw = dict(PARAMS[name], batch_size=32)
    jm, tm = _mappers_of(index, **kw)
    reads, lens, quals = _reads(index[0])
    got = tm.map_reads(reads, lens, quals)
    want = jm.map_reads(reads, lens, quals.astype(np.int32))
    assert _fields(got) == _fields(want)
    assert ((tm.locate_dropped, tm.escalated, tm.overflowed)
            == (jm.locate_dropped, jm.escalated, jm.overflowed) == (0, 0, 0))
    assert sum(r.aligned for r in got) >= 40


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden single-end dataset with an index built by the port."""
    from nvbio_tpu_torch.tools.build_index import main as build

    d = tmp_path_factory.mktemp("mem_se")
    reads = _write_se(d)
    assert build([str(d / "g.fa"), str(d / "g.npz")]) == 0
    return d, reads


CLI = {"default": ([], "sam"), "local": (["--local"], "sam"),
       "k25-smems4": (["-k", "25", "--max-smems", "4"], "sam"),
       "bam": ([], "bam")}


@pytest.mark.parametrize("name", sorted(CLI))
def test_mem_map_cli_equals_reference(golden, name):
    from nvbio_tpu.tools.mem_map import main as ref_mem
    from nvbio_tpu_torch.tools.mem_map import main as port_mem

    d, reads = golden
    flags, ext = CLI[name]
    common = ["-x", str(d / "g.npz"), *reads, "--batch", "128", *flags]
    assert port_mem([*common, "-S", str(d / f"port.{ext}"), "--device",
                     "cpu", "--stats", str(d / "port.json")]) == 0
    ref_mem([*common, "-S", str(d / f"ref.{ext}"), "--cpu"])
    if ext == "bam":
        got, want = _masked(d / "port.bam"), _masked(d / "ref.bam")
        assert gzip.open(d / "port.bam", "rb").read(4) == b"BAM\x01"
        assert "@PG\tID:tpu_mem" in gzip.open(d / "port.bam").read().decode(
            "latin-1")
        recs = want[1]
    else:
        got, want = ([ln for ln in open(d / f"{w}.sam")
                      if not ln.startswith("@PG")] for w in ("port", "ref"))
        assert any(ln.startswith("@PG\tID:tpu_mem")
                   for ln in open(d / "port.sam"))
        recs = [ln for ln in got if not ln.startswith("@")]
        assert sum(not int(ln.split("\t")[1]) & 4 for ln in recs) > 270
    assert got == want and len(recs) > 0
    import json
    stats = json.load(open(d / "port.json"))
    assert stats["reads"] == 300 and stats["device"] == "cpu"
    assert {"load_s", "map_s", "reads_per_s", "overflowed"} <= set(stats)
