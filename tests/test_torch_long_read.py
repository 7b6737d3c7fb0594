"""The port's long-read slice (reads > 512 bp, K4 in extension and
traceback) end to end against the JAX package on the CPU: 8 simulated
reads of 2 kb at band_w 63 and max_read_len 2048, mapped by the port's
Mapper and by the JAX Mapper(use_pallas=False) over the same JAX-built
index — map_batch and traceback_walk_batch field by field, MapResults
equal — and one CLI run of each whose SAM records are identical (the
@PG line aside).  Exact comparisons: every field is an integer or a
string."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.fmindex.build import build_fm_index, build_kmer_lut
from nvbio_tpu.io.fasta import write_fasta
from nvbio_tpu.io.fastq import write_fastq
from nvbio_tpu.models import mapper as jax_mapper
from nvbio_tpu.models import params as jax_params
from nvbio_tpu.utils.simulate import random_genome, simulate_reads
from nvbio_tpu_torch.io.index_file import index_from_numpy
from nvbio_tpu_torch.models import mapper, params
from nvbio_tpu_torch.ops import banded_dp
from nvbio_tpu_torch.strings.string_set import pack_reads

R, L = 8, 2000
BAND_W, MAX_LEN, LUT_K = 63, 2048, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the plain DP runs ~30 small ops per
    pattern row, which slow down many times over when the test workers'
    thread pools fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    g = random_genome(300_000, seed=18)
    fm, ssa = build_fm_index(g, sa_sample=4, bi_sample=True)
    lut = build_kmer_lut(g, k=LUT_K)
    kw = dict(seed_interval_fn="S", seed_interval_a=1.0,
              seed_interval_b=1.15, batch_size=R, max_read_len=MAX_LEN,
              band_w=BAND_W, lut_k=LUT_K)
    jm = jax_mapper.Mapper(fm, ssa, g, params=jax_params.MapperParams(**kw),
                           use_pallas=False, lut=lut)
    tfm, tssa, tg, tlut = index_from_numpy(
        [np.asarray(x) for x in fm[:6]], [np.asarray(x) for x in ssa], g,
        [np.asarray(x) for x in lut])
    tm = mapper.Mapper(tfm, tssa, tg, params=params.MapperParams(**kw),
                       lut=tlut)
    sim = simulate_reads(g, R, L, seed=19, error_rate=0.02,
                         indel_rate=0.005)
    reads, lens, qmat, _ = pack_reads(
        [s.astype(np.uint8) for s in sim["seqs"]], list(sim["quals"]),
        max_len=MAX_LEN)
    reads, qmat = mapper.Mapper._len_bucket(reads, lens, qmat)
    assert reads.shape[1] > banded_dp.LONG_THRESHOLD
    return g, jm, tm, sim, (reads, lens, qmat)


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got.cpu() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), what)


def test_long_map_batch_and_traceback_match_jax(setup):
    _, jm, tm, _, (reads, lens, qmat) = setup
    p = tm._chunk_params(lens.max(), lens.min())
    jp = jm._chunk_params(lens.max(), lens.min())
    jr, jl, jq = (jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(qmat))
    tr, tl, tq = (torch.from_numpy(reads), torch.from_numpy(lens).long(),
                  torch.from_numpy(qmat))
    ushift = reads.shape[1] - int(lens.max())
    want = jm._forward(jr, jl, jq, uniform_shift=ushift, params=jp)
    got = mapper.map_batch(tm.fm, tm.ssa, tm.gwords, tr, tl, tq, params=p,
                           lut=tm.lut, uniform_shift=ushift,
                           genome=tm.genome)
    for k in want:
        _eq(got[k], want[k], k)
    aligned = np.asarray(want["aligned"])
    assert aligned.sum() >= R - 1

    res_w, walk_w = jax_mapper.traceback_walk_batch(
        jm.genome, jnp.asarray(jm.n, jnp.int32), jr, jl, jq,
        want["win_start"], want["strand"], params=jp, use_pallas=False,
        active=want["aligned"])
    res_g, walk_g = mapper.traceback_walk_batch(
        tm.genome, tm.n, tr, tl, tq, got["win_start"], got["strand"],
        params=p, active=got["aligned"])
    for k in res_w:
        _eq(res_g[k], res_w[k], k)
    for k in walk_w:
        _eq(walk_g[k], walk_w[k], k)
    # the CIGARs cross the simulated indels: more than one run per read
    assert (np.asarray(walk_g["run_lens"])[aligned] > 0).sum(1).min() > 1


def test_long_map_reads_results_match_jax(setup):
    _, jm, tm, sim, (reads, lens, qmat) = setup
    got = tm.map_reads(reads, lens, qmat)
    assert got == [mapper.MapResult(**dataclasses.asdict(r))
                   for r in jm.map_reads(reads, lens, qmat)]
    # on the true strand within 40 bp of the truth (tests/test_long_read.py)
    near = [r.aligned and r.strand == sim["true_strand"][i]
            and abs(r.pos - int(sim["true_pos"][i])) <= 40
            for i, r in enumerate(got)]
    assert sum(near) >= R - 1


def test_long_read_cli_sam_matches_jax(setup, tmp_path):
    """map_reads --max-read-len 2048 --band 63: the port's --device cpu
    run writes the SAM records of the JAX CLI's --cpu run."""
    from nvbio_tpu.tools.map_reads import main as jax_cli
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as torch_cli

    g, _, _, sim, _ = setup
    write_fasta(str(tmp_path / "g.fa"), [("long_ref", g)])
    write_fastq(str(tmp_path / "r.fq"), [
        (f"lr{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(R)])
    build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz"), "--lut-k",
           str(LUT_K)])
    args = ["-x", str(tmp_path / "g.npz"), "-U", str(tmp_path / "r.fq"),
            "--max-read-len", str(MAX_LEN), "--band", str(BAND_W),
            "--batch", str(R)]
    assert torch_cli(args + ["-S", str(tmp_path / "t.sam"), "--device",
                             "cpu"]) == 0
    jax_cli(args + ["-S", str(tmp_path / "j.sam"), "--cpu"])

    def records(path):
        return [ln for ln in open(path) if not ln.startswith("@PG")]

    got, want = records(tmp_path / "t.sam"), records(tmp_path / "j.sam")
    assert got == want
    body = [ln.split("\t") for ln in got if not ln.startswith("@")]
    assert len(body) == R
    assert sum(int(f[1]) & 4 == 0 for f in body) >= R - 1
