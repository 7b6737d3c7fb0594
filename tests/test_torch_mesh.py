"""The port's shard-per-device mesh (``models/mesh_sharded.py``) and
device lists (``parallel/mesh.py``) on ``[cpu] * S``, mirroring
tests/test_mesh_sharded.py: every result equals the port's sequential
ShardedMapper's, and both equal the reference's ShardedMapper on the same
genome, shards and reads (SE over 3 and 4 shards, PE with pairs across
the shard edges, -a on a planted duplicate, a partial batch); a batch
that does not divide by S and a host with fewer cards than shards are
refused with the reference's messages; ``map_reads --mesh on`` writes
``--mesh off``'s SAM (tests/test_tools.py:298); and the data-parallel
leg of tests/test_parallel.py: map_batch on one device equals map_batch
over a ``[cpu] * 4`` ``shard_reads`` split, key by key."""

import json

import numpy as np
import pytest
import torch

from nvbio_tpu.fmindex import sharded as jax_sharded
from nvbio_tpu.models import sharded_mapper as jax_sm
from nvbio_tpu.models.params import MapperParams as JaxParams
from nvbio_tpu_torch.fmindex import sharded
from nvbio_tpu_torch.models import mesh_sharded
from nvbio_tpu_torch.models.params import MapperParams
from nvbio_tpu_torch.models.sharded_mapper import (PairedShardedMapper,
                                                   ShardedMapper)
from nvbio_tpu_torch.utils.simulate import (random_genome, simulate_pairs,
                                            simulate_reads)

CPU = torch.device("cpu")
IDX = dict(overlap=2048, sa_sample=16, lut_k=8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as the other port tests (the plain DP's
    small per-row ops slow down when the workers' pools fight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    genome = random_genome(180_000, seed=31)
    sim = simulate_reads(genome, 96, 100, seed=32)
    lens = np.full(96, 100, np.int32)
    quals = np.full((96, 100), 35, np.uint8)
    return genome, sim["seqs"].astype(np.uint8), lens, quals


def _key(r):
    return (r.aligned, r.pos, r.strand, r.cigar, r.score, r.mapq, r.md,
            r.nm, r.second) if r.aligned else (False,)


def _mappers(genome, shard_bp, kw, paired=False):
    """The port's sequential and mesh mappers on one port-built index, and
    the reference's sequential mapper on its own build of the same
    shards (tests/test_torch_sharded.py holds the two builds equal)."""
    params = MapperParams(**kw)
    tidx = sharded.build_sharded_index(genome, shard_bp=shard_bp, **IDX)
    S = len(tidx.shards)
    seq_cls = PairedShardedMapper if paired else ShardedMapper
    mesh_cls = (mesh_sharded.MeshPairedShardedMapper if paired
                else mesh_sharded.MeshShardedMapper)
    jcls = jax_sm.PairedShardedMapper if paired else jax_sm.ShardedMapper
    jm = jcls(jax_sharded.build_sharded_index(genome, shard_bp=shard_bp,
                                              **IDX),
              genome, params=JaxParams(**kw), use_pallas=False)
    return (seq_cls(tidx, genome, params=params),
            mesh_cls(tidx, genome, params=params, devices=[CPU] * S), jm, S)


@pytest.mark.parametrize("n_shards", [3, 4])
def test_mesh_matches_sequential(setup, n_shards):
    genome, seqs, lens, quals = setup
    seq, mesh, jm, S = _mappers(
        genome, (len(genome) + n_shards - 1) // n_shards,
        dict(batch_size=96, sa_sample=16, max_candidates=8, lut_k=8))
    assert S == n_shards
    rs = seq.map_reads(seqs, lens, quals)
    rm = mesh.map_reads(seqs, lens, quals)
    rj = jm.map_reads(seqs, lens, quals)
    assert [_key(r) for r in rm] == [_key(r) for r in rs]
    assert [_key(r) for r in rm] == [_key(r) for r in rj]
    assert sum(r.aligned for r in rm) >= 90
    assert mesh.locate_dropped == seq.locate_dropped == jm.locate_dropped


def test_mesh_batch_not_divisible_rejected(setup):
    genome, *_ = setup
    tidx = sharded.build_sharded_index(genome, shard_bp=60_000, **IDX)
    with pytest.raises(ValueError, match="divide"):
        mesh_sharded.MeshShardedMapper(
            tidx, genome, params=MapperParams(batch_size=100, sa_sample=16),
            devices=[CPU] * 3)


def test_mesh_needs_a_card_a_shard(setup, monkeypatch):
    """Without a device list the mesh takes the first S cards; with
    fewer it raises the reference's ValueError."""
    genome, *_ = setup
    tidx = sharded.build_sharded_index(genome, shard_bp=60_000, **IDX)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"^need >= 3 devices for 3 shards, "
                       r"have 1 \(use the sequential ShardedMapper\)$"):
        mesh_sharded.MeshShardedMapper(
            tidx, genome, params=MapperParams(batch_size=96, sa_sample=16))


def test_mesh_hbm_budget_by_device(setup):
    """hbm_budget groups shards by device: a shared device counts its
    shards' resident bytes and stage transients together, and the CPU
    has no limit."""
    genome, *_ = setup
    tidx = sharded.build_sharded_index(genome, shard_bp=60_000, **IDX)
    mesh = mesh_sharded.MeshShardedMapper(
        tidx, genome, params=MapperParams(batch_size=96, sa_sample=16),
        devices=[CPU] * 3)
    b = mesh.hbm_budget()
    assert list(b) == ["cpu"] and b["cpu"]["shards"] == [0, 1, 2]
    assert b["cpu"]["limit"] is None
    assert b["cpu"]["resident_index"] == sum(mesh._resident) > 0
    assert b["cpu"]["total"] == (b["cpu"]["resident_index"]
                                 + b["cpu"]["transient_batch"])
    # transients grow with the batch
    assert (mesh.hbm_budget(192)["cpu"]["transient_batch"]
            > b["cpu"]["transient_batch"])


def test_mesh_paired_matches_sequential(setup):
    """PE: pair decisions and both mates' fields equal, boundary-
    straddling fragments included."""
    genome, *_ = setup
    sim = simulate_pairs(genome, 56, 100, insert_mean=250, insert_sd=25,
                         seed=12)
    s1, s2 = sim["seqs1"].copy(), sim["seqs2"].copy()
    for j, fs in enumerate([59_820, 59_900, 59_960, 59_990,
                            119_820, 119_900, 119_960, 119_990]):
        i = 48 + j
        s1[i] = genome[fs:fs + 100]
        frag2 = genome[fs + 250 - 100:fs + 250]
        s2[i] = np.where(frag2 < 4, 3 - frag2, frag2)[::-1]
    lens = np.full(56, 100, np.int32)
    q = np.full((56, 100), 35, np.uint8)
    seq, mesh, jm, _ = _mappers(
        genome, 60_000, dict(batch_size=48, sa_sample=16, max_candidates=8,
                             lut_k=8, minins=0, maxins=400), paired=True)
    out = [m.map_pairs(s1, lens, q, s2, lens, q) for m in (seq, mesh, jm)]
    for r1, r2, info in out[1:]:
        assert info == out[0][2]
        assert [_key(r) for r in r1] == [_key(r) for r in out[0][0]]
        assert [_key(r) for r in r2] == [_key(r) for r in out[0][1]]
    info = out[1][2]
    assert sum(i["proper"] for i in info) >= 50
    assert info[48]["proper"] and info[55]["proper"]
    assert mesh.rescued == seq.rescued


def test_mesh_all_matches_sequential(setup):
    """-a: per-read alignment lists equal (count, order, fields)."""
    genome, *_ = setup
    g = genome.copy()
    g[150_000:152_000] = g[30_000:32_000]
    reads = np.stack([g[30_000 + 37 * i: 30_100 + 37 * i]
                      for i in range(24)]).astype(np.uint8)
    lens = np.full(24, 100, np.int32)
    quals = np.full((24, 100), 35, np.uint8)
    seq, mesh, jm, _ = _mappers(g, 60_000, dict(
        batch_size=48, sa_sample=16, max_candidates=8, lut_k=8))
    alls = [m.map_reads_all(reads, lens, quals, max_alns=4)
            for m in (seq, mesh, jm)]
    for got in alls[1:]:
        assert [[_key(a) for a in xs] for xs in got] == \
               [[_key(a) for a in xs] for xs in alls[0]]
    assert sum(len(xs) > 1 for xs in alls[1]) >= 20


def test_mesh_partial_batch(setup):
    genome, seqs, lens, quals = setup
    seq, mesh, jm, _ = _mappers(genome, 45_000, dict(
        batch_size=64, sa_sample=16, max_candidates=8, lut_k=8))
    rs, rm, rj = (m.map_reads(seqs[:40], lens[:40], quals[:40])
                  for m in (seq, mesh, jm))
    assert [_key(r) for r in rm] == [_key(r) for r in rs] == \
           [_key(r) for r in rj]


def _sam_body(path):
    return [ln for ln in open(path) if not ln.startswith("@")]


def test_map_reads_mesh_cli(tmp_path):
    """map_reads --mesh on (3 shards over [cpu] * 3) writes --mesh off's
    SAM, SE and PE; a batch that does not divide by 3 is refused."""
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.tools import build_index, map_reads

    g = random_genome(60_000, seed=77)
    write_fasta(tmp_path / "ref.fa", [("chrM", g)])
    assert build_index.main([
        str(tmp_path / "ref.fa"), str(tmp_path / "idx.npz"),
        "--sa-sample", "8", "--shard-bp", "20000"]) == 0
    man = json.load(open(tmp_path / "idx.manifest.json"))
    assert len(man["shards"]) == 3
    sim = simulate_reads(g, 48, 100, seed=5)
    write_fastq(tmp_path / "se.fq",
                [(f"r{i}", sim["seqs"][i].astype(np.uint8),
                  sim["quals"][i]) for i in range(48)])
    pe = simulate_pairs(g, 24, 100, seed=6)
    for m in (1, 2):
        write_fastq(tmp_path / f"m{m}.fq",
                    [(f"p{i}", pe[f"seqs{m}"][i].astype(np.uint8),
                      pe[f"quals{m}"][i]) for i in range(24)])
    common = ["-x", str(tmp_path / "idx.manifest.json"), "--batch", "48",
              "--device", "cpu", "--max-read-len", "128"]
    for name, reads in (("se", ["-U", str(tmp_path / "se.fq")]),
                        ("pe", ["-1", str(tmp_path / "m1.fq"), "-2",
                                str(tmp_path / "m2.fq")])):
        for mode in ("off", "on"):
            assert map_reads.main(common + reads + [
                "-S", str(tmp_path / f"{name}_{mode}.sam"), "--mesh",
                mode]) == 0
        on, off = (_sam_body(tmp_path / f"{name}_on.sam"),
                   _sam_body(tmp_path / f"{name}_off.sam"))
        assert on == off and len(on) == 48
        assert sum(not int(ln.split("\t")[1]) & 4 for ln in on) >= 44
    with pytest.raises(SystemExit):
        map_reads.main(common[:2] + ["--batch", "50"] + common[4:] + [
            "-U", str(tmp_path / "se.fq"), "-S", str(tmp_path / "x.sam"),
            "--mesh", "on"])


def test_data_parallel_map_batch_matches_single(setup):
    """map_batch over a replicated index and reads split over [cpu] * 4
    (parallel.mesh) equals one map_batch over the whole batch."""
    from nvbio_tpu_torch.fmindex.build import build_fm_arrays
    from nvbio_tpu_torch.io.index_file import index_from_numpy
    from nvbio_tpu_torch.models.mapper import PAD, map_batch
    from nvbio_tpu_torch.ops.banded_dp import pack_genome_words
    from nvbio_tpu_torch.parallel import make_mesh, replicate, shard_reads

    n, R, L = 20_000, 32, 64
    params = MapperParams(batch_size=R, sa_sample=16, max_candidates=8,
                          lut_k=0)
    g = random_genome(n, seed=11)
    fm, ssa, _, _ = index_from_numpy(*build_fm_arrays(g, sa_sample=16), g)
    gp = np.full(n + params.max_read_len + 2 * params.band_w + 8, PAD,
                 np.int8)
    gp[:n] = g
    state = (fm, ssa, pack_genome_words(g), torch.from_numpy(gp))
    sim = simulate_reads(g, R, L, seed=12)
    batch = (torch.from_numpy(sim["seqs"].astype(np.int8)),
             torch.full((R,), L, dtype=torch.int64),
             torch.from_numpy(sim["quals"].astype(np.uint8)))
    want = map_batch(*state[:3], *batch, params=params, genome=state[3])

    mesh = make_mesh(4, "cpu")
    assert mesh == [CPU] * 4
    parts = [map_batch(*st[:3], r, ln, q, params=params, genome=st[3])
             for st, r, ln, q in zip(replicate(mesh, state),
                                     *shard_reads(mesh, *batch))]
    assert set(parts[0]) == set(want)
    for k, w in want.items():
        got = (sum(p[k] for p in parts) if w.dim() == 0
               else torch.cat([p[k] for p in parts]))
        torch.testing.assert_close(got, w, rtol=0, atol=0, msg=k)
    assert int(want["aligned"].sum()) >= 28
