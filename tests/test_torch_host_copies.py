"""The port's copies of the host code (``nvbio_tpu_torch.basic``,
``.io``, ``.native``, ``.utils``) give the originals' outputs on seeded
inputs.  The copies exist so that the port imports nothing of
``nvbio_tpu``; this holds them to the reference they were copied from."""

import numpy as np
import pytest

import nvbio_tpu.basic.packed as ref_packed
import nvbio_tpu.io.genome as ref_genome
import nvbio_tpu.io.sam as ref_sam
import nvbio_tpu.native as ref_native
import nvbio_tpu.utils.simulate as ref_simulate
import nvbio_tpu_torch.basic.packed as port_packed
import nvbio_tpu_torch.io.genome as port_genome
import nvbio_tpu_torch.io.sam as port_sam
import nvbio_tpu_torch.native as port_native
import nvbio_tpu_torch.utils.simulate as port_simulate


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _text(seed, n=20_000):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _fastq_bytes(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(50):
        n = int(rng.integers(1, 120))
        seq = "".join("ACGTN"[c] for c in rng.integers(0, 5, n))
        qual = "".join(chr(33 + q) for q in rng.integers(0, 42, n))
        out.append(f"@read{i} extra\n{seq}\n+\n{qual}\n")
    return "".join(out).encode()


def _ops_batch_args(seed):
    rng = np.random.default_rng(seed)
    R, Lp, SP = 12, 60, 90
    genome = rng.integers(0, 4, 5_000).astype(np.int8)
    pats = rng.integers(0, 4, (R, Lp)).astype(np.uint8)
    plens = rng.integers(30, Lp + 1, R).astype(np.int32)
    ops = np.zeros((R, SP), np.uint8)
    for r in range(R):  # END->START op streams: M runs with a D and an I
        seq = [1] * 10 + [2] * 3 + [1] * 12 + [3] * 2 + [1] * (plens[r] - 24)
        ops[r, :len(seq)] = seq
    return (ops, np.zeros(R, np.int32), np.zeros(R, np.int32),
            np.ones(R, np.uint8), pats, plens, genome,
            rng.integers(0, 4_000, R).astype(np.int64), False)


CASES = {
    "sais_native": lambda m: m.sais_native(_text(1)),
    "kmer_hist_native": lambda m: m.kmer_hist_native(_text(2), 6),
    "fastq_parse_native": lambda m: m.fastq_parse_native(_fastq_bytes(3),
                                                         128),
    "ops_batch_native": lambda m: m.ops_batch_native(*_ops_batch_args(4)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_copies_match(name):
    want = CASES[name](ref_native)
    got = CASES[name](port_native)
    assert want is not None and got is not None
    _equal(got, want)


def test_pack_2bit_copy_matches():
    s = _text(5, 1_001)
    _equal(port_packed.pack_2bit(s), ref_packed.pack_2bit(s))
    w = ref_packed.pack_2bit(s)
    _equal(port_packed.unpack_2bit(w, len(s)),
           ref_packed.unpack_2bit(w, len(s)))
    _equal(port_packed.popc_2bit_word(w, 2), ref_packed.popc_2bit_word(w, 2))


def test_simulate_reads_copy_matches():
    g = ref_simulate.random_genome(50_000, seed=6)
    _equal(port_simulate.random_genome(50_000, seed=6), g)
    kw = dict(seed=7, error_rate=0.02, indel_rate=0.005)
    _equal(port_simulate.simulate_reads(g, 64, 100, **kw),
           ref_simulate.simulate_reads(g, 64, 100, **kw))


def test_prepare_genome_copy_matches():
    rng = np.random.default_rng(8)
    recs = [(f"c{i}", rng.integers(0, 5, int(rng.integers(100, 900)))
             .astype(np.uint8)) for i in range(4)]
    _equal(port_genome.prepare_genome(recs), ref_genome.prepare_genome(recs))


def test_sam_writer_copy_matches(tmp_path):
    def write(mod, path):
        with mod.SamWriter(str(path), ["c1", "c2"], [1000, 2000]) as w:
            for i in range(5):
                w.write(mod.SamRecord(
                    qname=f"r{i}", flag=16 * (i % 2), rname="c1", pos=i + 1,
                    mapq=40 - i, cigar="10M1D5M", seq="ACGT" * 4,
                    qual="I" * 16, tags=[("AS", "i", -i), ("MD", "Z", "10^A5")]))
        return path.read_bytes()

    assert (write(port_sam, tmp_path / "port.sam")
            == write(ref_sam, tmp_path / "ref.sam"))
