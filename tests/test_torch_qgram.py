"""The q-gram mapper of the port against the JAX package on the CPU,
exact equality throughout: ``build_qgram_index``' keys and positions,
``qgram_filter``'s (diag, valid), every key of ``qgram_map_batch``'s
output, ``QGramMapper.map_reads``' MapResults and counters, and the
``qmap`` CLI's SAM (@PG masked) on the golden single-end dataset,
default, -q 12 --stride 5 --max-hits 4 and --local.  The genome holds a
segment copied 12 times, so its grams have more hits than --max-hits:
which hits the filter keeps is the stable index build's choice."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.models.params import MapperParams as JaxParams
from nvbio_tpu.models.qgram_mapper import QGramMapper as JaxQGramMapper
from nvbio_tpu.qgram import index as jax_qgram
from nvbio_tpu.utils.simulate import random_genome, simulate_reads
from nvbio_tpu_torch.models.params import MapperParams
from nvbio_tpu_torch.models.qgram_mapper import QGramMapper
from nvbio_tpu_torch.qgram import index as qgram
from nvbio_tpu_torch.strings.string_set import pack_reads
from test_torch_bam import _write_se
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
    """A 60 kb genome with a 300 bp segment copied 12 times, its JAX
    index and the port's copy of it."""
    g = random_genome(60_000, seed=31)
    for k in range(12):
        g[40_000 + 400 * k: 40_300 + 400 * k] = g[10_000:10_300]
    return (g, *_mappers(g, 16))


def test_qgram_keys_and_index_match_jax(index):
    g = index[0]
    np.testing.assert_array_equal(qgram.qgram_keys(g, 11),
                                  jax_qgram.qgram_keys(g, 11))
    want = jax_qgram.build_qgram_index(g, q=11)
    got = qgram.build_qgram_index(g, q=11)
    assert got.q == want.q == 11
    assert got.keys.dtype == got.pos.dtype == torch.int32
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    with pytest.raises(ValueError):
        qgram.qgram_keys(g, 16)


@pytest.mark.parametrize("max_hits", [4, 16])
def test_qgram_filter_matches_jax(index, max_hits):
    """Grams of the repeat (12 hits and more), of unique sequence, keys
    absent from the genome and -1 (a gram with an N)."""
    g = index[0]
    rng = np.random.default_rng(3)
    q = 11
    all_keys = qgram.qgram_keys(g, q)
    starts = np.concatenate([rng.integers(10_000, 10_280, 20),
                             rng.integers(0, len(g) - q, 20)])
    present = set(all_keys.tolist())
    absent = [k for k in rng.integers(0, 4 ** q, 200) if k not in present][:8]
    queries = np.concatenate([all_keys[starts], absent, [-1, -1]]).astype(
        np.int32)
    offsets = rng.integers(0, 90, len(queries)).astype(np.int32)
    want = jax_qgram.qgram_filter(jax_qgram.build_qgram_index(g, q=q),
                                  jnp.asarray(queries), jnp.asarray(offsets),
                                  max_hits)
    got = qgram.qgram_filter(qgram.build_qgram_index(g, q=q),
                             torch.from_numpy(queries),
                             torch.from_numpy(offsets), max_hits)
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))
    valid = got[1].numpy()
    # the repeat's grams have 13 hits or more, the others one or more
    assert (valid[:20].sum(1) >= min(13, max_hits)).all()
    assert valid[:40, 0].all() and not valid[40:].any()


def _reads(g):
    """Simulated reads (2 % errors, indels), reads of the repeat, reads
    with an N, random reads and short reads, packed to 128 columns."""
    sim = simulate_reads(g, 48, 100, seed=9, error_rate=0.02,
                         indel_rate=0.005)
    seqs = [s.astype(np.uint8) for s in sim["seqs"]]
    seqs[:6] = [g[10_000 + 35 * k: 10_100 + 35 * k].astype(np.uint8)
                for k in range(6)]
    for k in range(6, 10):
        seqs[k] = seqs[k].copy()
        seqs[k][7 * k] = 4
    rng = np.random.default_rng(4)
    seqs += [rng.integers(0, 4, 100).astype(np.uint8) for _ in range(4)]
    seqs += [g[20_000:20_070].astype(np.uint8), g[30_000:30_013].astype(
        np.uint8)]
    quals = [np.full(len(s), 30, np.uint8) for s in seqs]
    reads, lens, q, _ = pack_reads(seqs, quals, max_len=128)
    return reads, lens, q


SETTINGS = {"default": ({}, {}),
            "q12-s5-h4": (dict(q=12, stride=5, max_hits=4), {}),
            "local": ({}, dict(local=True))}


def _mappers_of(index, name, batch_size=64):
    g, fm, ssa, tfm, tssa, tg = index
    qkw, pkw = SETTINGS[name]
    kw = dict(batch_size=batch_size, sa_sample=16, **pkw)
    jm = JaxQGramMapper(fm, ssa, g, params=JaxParams(**kw), use_pallas=False,
                        **qkw)
    tm = QGramMapper(tfm, tssa, tg, params=MapperParams(**kw), **qkw)
    return jm, tm


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_qgram_map_batch_matches_jax(index, name):
    jm, tm = _mappers_of(index, name)
    np.testing.assert_array_equal(tm.qidx.pos.numpy(),
                                  np.asarray(jm.qidx.pos))
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


@pytest.mark.parametrize("name", ["default", "q12-s5-h4"])
def test_qgram_mapper_map_reads_matches_jax(index, name):
    jm, tm = _mappers_of(index, name, batch_size=32)
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

    d = tmp_path_factory.mktemp("qmap_se")
    reads = _write_se(d)
    assert build([str(d / "g.fa"), str(d / "g.npz")]) == 0
    return d, reads


CLI = {"default": [], "q12-s5-h4": ["-q", "12", "--stride", "5",
                                    "--max-hits", "4"],
       "local": ["--local"]}


@pytest.mark.parametrize("name", sorted(CLI))
def test_qmap_cli_equals_reference(golden, name):
    from nvbio_tpu.tools.qmap import main as ref_qmap
    from nvbio_tpu_torch.tools.qmap import main as port_qmap

    d, reads = golden
    common = ["-x", str(d / "g.npz"), *reads, "--batch", "128", *CLI[name]]
    assert port_qmap([*common, "-S", str(d / "port.sam"), "--device", "cpu",
                      "--stats", str(d / "port.json")]) == 0
    ref_qmap([*common, "-S", str(d / "ref.sam"), "--cpu"])
    got, want = ([ln for ln in open(d / f"{w}.sam")
                  if not ln.startswith("@PG")] for w in ("port", "ref"))
    assert got == want
    assert any(ln.startswith("@PG\tID:tpu_qmap")
               for ln in open(d / "port.sam"))
    recs = [ln for ln in got if not ln.startswith("@")]
    assert len(recs) == 300
    assert sum(not int(ln.split("\t")[1]) & 4 for ln in recs) > 270
    stats = json.load(open(d / "port.json"))
    assert stats["reads"] == 300 and stats["device"] == "cpu"
    assert {"load_s", "map_s", "reads_per_s", "overflowed"} <= set(stats)
