"""The Bloom filter / count-min sketch and the nvLighter-style corrector
in the port (``basic/bloom.py``, ``models/corrector.py``,
``tools/correct_reads.py``) against the JAX package on the same seeded
inputs: the hash on edge keys, the counting insert (also past a uint8
slot's 255, where both wrap), the membership filter, the corrector's
reads and counts at k 15 over one and two rounds, and the CLI's FASTQ.
Tolerance: exact, every output is an integer.  CUDA = CPU is checked on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvbio_tpu.basic.bloom as jbloom
import nvbio_tpu_torch.basic.bloom as tbloom

EDGE_KEYS = np.array([-1, 0, 1, 2**31 - 1, -2**31, 0x7FEB352D, -0x7B935975,
                      65535, 65536], np.int32)


@pytest.mark.parametrize("h", range(8))
def test_mix_equals_jax_on_edge_and_random_keys(h):
    keys = np.concatenate([EDGE_KEYS, np.random.default_rng(h).integers(
        -2**31, 2**31, 4096).astype(np.int32)])
    want = np.asarray(jbloom._mix(jnp.asarray(keys), jbloom._SALTS[h]))
    got = tbloom._mix(torch.from_numpy(keys), tbloom._SALTS[h])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert tbloom._SALTS[h] == int(jbloom._SALTS[h])


@pytest.mark.parametrize("log2_slots,weighted", [
    (4, True), (4, False), (12, True)], ids=["wrap-w", "wrap", "sparse-w"])
def test_counting_insert_and_query_equal_jax(log2_slots, weighted):
    """16 slots take ~375 increments each: every slot wraps past 255."""
    rng = np.random.default_rng(log2_slots)
    keys = rng.integers(-2**31, 2**31, (40, 75)).astype(np.int32)
    w = rng.integers(0, 2, keys.shape).astype(bool) if weighted else None
    jb = jbloom.counting_insert(jbloom.make_bloom(log2_slots),
                                jnp.asarray(keys),
                                None if w is None else jnp.asarray(w))
    tb = tbloom.counting_insert(tbloom.make_bloom(log2_slots),
                                torch.from_numpy(keys),
                                None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(tb.slots.numpy(), np.asarray(jb.slots))
    if log2_slots == 4:
        assert (keys.size * 4 // 16 > 255)
    q = np.concatenate([keys[:5].reshape(-1), EDGE_KEYS]).reshape(-1, 1)
    np.testing.assert_array_equal(
        tbloom.counting_query(tb, torch.from_numpy(q)).numpy(),
        np.asarray(jbloom.counting_query(jb, jnp.asarray(q))))


def test_bloom_insert_and_query_equal_jax():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 20, 3000).astype(np.int32)
    probe = rng.integers(0, 1 << 20, (50, 40)).astype(np.int32)
    jb = jbloom.bloom_insert(jbloom.make_bloom(14, 3), jnp.asarray(keys))
    tb = tbloom.bloom_insert(tbloom.make_bloom(14, 3), torch.from_numpy(keys))
    np.testing.assert_array_equal(tb.slots.numpy(), np.asarray(jb.slots))
    got = tbloom.bloom_query(tb, torch.from_numpy(probe))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbloom.bloom_query(jb, jnp.asarray(probe))))
    assert tbloom.bloom_query(tb, torch.from_numpy(keys[:100])).all()


def _sim_reads(n_reads=3000, glen=12_000, seed=4):
    """Reads from both strands with 1 % substitutions (simulate_reads,
    no indels), N bases, one short read; their error-free originals."""
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads

    g = random_genome(glen, seed=seed)
    sim = simulate_reads(g, n_reads, 100, error_rate=0.01, indel_rate=0.0,
                         seed=seed + 1)
    reads = sim["seqs"].astype(np.int8)
    reads[3, 40] = 4
    lens = np.full(n_reads, 100, np.int32)
    lens[5] = 60
    reads[5, 60:] = 7
    return reads, lens, sim


@pytest.fixture(scope="module")
def sim_reads():
    return _sim_reads()


@pytest.mark.parametrize("rounds", [1, 2])
def test_error_correct_equals_jax(sim_reads, rounds):
    from nvbio_tpu.models.corrector import Corrector as JaxCorrector
    from nvbio_tpu_torch.models.corrector import Corrector

    reads, lens, _ = sim_reads
    half = len(reads) // 2
    batches = [(reads[:half], lens[:half]), (reads[half:], lens[half:])]
    jc = JaxCorrector.build([b[0] for b in batches], [b[1] for b in batches],
                            k=15, log2_slots=18)
    tc = Corrector.build([b[0] for b in batches], [b[1] for b in batches],
                         k=15, log2_slots=18)
    np.testing.assert_array_equal(tc.bf.slots.numpy(), np.asarray(jc.bf.slots))
    want = jc.correct(reads, lens, rounds=rounds)
    got = tc.correct(reads, lens, rounds=rounds)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() > 500  # ~0.9 errors a read, most of them fixed


def test_correct_reads_cli_fastq_equals_reference(sim_reads, tmp_path,
                                                  capsys):
    from nvbio_tpu.tools.correct_reads import main as ref_main
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.tools.correct_reads import main

    reads, lens, sim = sim_reads
    fq = tmp_path / "r.fq"
    write_fastq(str(fq), [(f"r{i} c", reads[i, :lens[i]].astype(np.uint8),
                           sim["quals"][i, :lens[i]])
                          for i in range(len(reads))])
    args = [str(fq), "-k", "15", "--log2-slots", "18", "--rounds", "2",
            "--batch", "1000", "--max-read-len", "128"]
    assert ref_main(args[:1] + [str(tmp_path / "ref.fq")] + args[1:]
                    + ["--cpu"]) == 0
    ref_err = capsys.readouterr().err
    assert main(args[:1] + [str(tmp_path / "port.fq.gz")] + args[1:]
                + ["--device", "cpu"]) == 0
    assert capsys.readouterr().err == ref_err
    import gzip
    got = gzip.open(tmp_path / "port.fq.gz", "rb").read()
    assert got == (tmp_path / "ref.fq").read_bytes()
    assert " 3000 reads, " in ref_err
