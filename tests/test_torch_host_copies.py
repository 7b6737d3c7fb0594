"""The port's copies of the host code (``nvbio_tpu_torch.basic``,
``.io`` (BWA files and ``read_pac`` too), ``.alignment.blosum``,
``.alignment.cigar``, ``.alignment.oracle``,
``.native``, ``.utils``, ``.parallel``, ``.sufsort.sa``, the
bucketed sort's host helpers, the set-BWT oracle and the sharded index's
``_shard_bounds``) give the originals' outputs on seeded inputs.  The copies exist so that the port imports nothing of
``nvbio_tpu``; this holds them to the reference they were copied from."""

import gzip
import inspect

import numpy as np
import pytest

import nvbio_tpu.alignment.blosum as ref_blosum
import nvbio_tpu.alignment.cigar as ref_cigar
import nvbio_tpu.alignment.oracle as ref_oracle
import nvbio_tpu.basic.packed as ref_packed
import nvbio_tpu.fmindex.sharded as ref_sharded
import nvbio_tpu.io.bwa_files as ref_bwa
import nvbio_tpu.io.genome as ref_genome
import nvbio_tpu.io.index_file as ref_index_file
import nvbio_tpu.io.sam as ref_sam
import nvbio_tpu.native as ref_native
import nvbio_tpu.parallel.distributed as ref_dist
import nvbio_tpu.sufsort.bucketed as ref_bucketed
import nvbio_tpu.sufsort.device as ref_sufdev
import nvbio_tpu.sufsort.sa as ref_sa
import nvbio_tpu.utils.html as ref_html
import nvbio_tpu.utils.stats as ref_stats
import nvbio_tpu.utils.simulate as ref_simulate
import nvbio_tpu_torch.alignment.blosum as port_blosum
import nvbio_tpu_torch.alignment.cigar as port_cigar
import nvbio_tpu_torch.alignment.oracle as port_oracle
import nvbio_tpu_torch.basic.packed as port_packed
import nvbio_tpu_torch.fmindex.sharded as port_sharded
import nvbio_tpu_torch.io.bwa_files as port_bwa
import nvbio_tpu_torch.io.genome as port_genome
import nvbio_tpu_torch.io.index_file as port_index_file
import nvbio_tpu_torch.io.sam as port_sam
import nvbio_tpu_torch.native as port_native
import nvbio_tpu_torch.parallel.distributed as port_dist
import nvbio_tpu_torch.sufsort.bucketed as port_bucketed
import nvbio_tpu_torch.sufsort.device as port_sufdev
import nvbio_tpu_torch.sufsort.sa as port_sa
import nvbio_tpu_torch.utils.html as port_html
import nvbio_tpu_torch.utils.stats as port_stats
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


@pytest.mark.parametrize("n,shard_bp,overlap", [
    (3_088_269_832, 1_600_000_000, 1024), (64_444_167, 16_777_216, 1024),
    (61_024, 30_000, 1024), (61_025, 30_000, 1024), (150_000, 60_000, 2048),
    (60_000, 30_000, 0), (7, 2, 3), (0, 10, 1)])
def test_shard_bounds_copy_matches(n, shard_bp, overlap):
    _equal(port_sharded._shard_bounds(n, shard_bp, overlap),
           ref_sharded._shard_bounds(n, shard_bp, overlap))


def _sufsort_text(i):
    t = _text(11 + i, 5_000)
    if i == 1:  # a tandem array and a homopolymer run
        t[1000:3000] = np.tile(t[:5], 400)
        t[3000:3500] = 2
    return t


def _bwt_of(mod, t):
    return mod.bwt_from_sa(t, ref_sa.suffix_array(t))


def _read_set(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (20, 12)).astype(np.uint8),
            rng.integers(1, 13, 20).astype(np.int32))


SUFSORT_COPIES = {  # (reference module, port module, port's function)
    "sa.suffix_array": (ref_sa, port_sa, lambda m, i: m.suffix_array(
        _sufsort_text(i))),
    "sa.suffix_array_pd": (ref_sa, port_sa, lambda m, i: m.suffix_array_pd(
        _sufsort_text(i))),
    "sa.bwt_from_sa": (ref_sa, port_sa, lambda m, i: _bwt_of(
        m, _sufsort_text(i))),
    "bucketed._pack_nibbles": (ref_bucketed, port_bucketed,
                               lambda m, i: m._pack_nibbles(
                                   _sufsort_text(i), 20)),
    "bucketed._host_bucket_keys": (ref_bucketed, port_bucketed,
                                   lambda m, i: m._host_bucket_keys(
                                       _sufsort_text(i))),
    "device.set_bwt_oracle": (ref_sufdev, port_sufdev,
                              lambda m, i: m.set_bwt_oracle(
                                  *_read_set(i))),
}


@pytest.mark.parametrize("name", sorted(SUFSORT_COPIES))
def test_sufsort_copies_match(name):
    """The port's ``sufsort/sa.py`` and the host helpers of its device
    sorts are the reference's functions line for line, with equal
    outputs on a random and a repetitive input."""
    ref, port, call = SUFSORT_COPIES[name]
    fn = name.split(".")[1]
    assert (inspect.getsource(getattr(port, fn))
            == inspect.getsource(getattr(ref, fn)))
    for i in range(2):
        _equal(call(port, i), call(ref, i))


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


def _map_results(cls, seed, n=500):
    """Seeded MapResults: aligned or not, with or without a second-best,
    MAPQ 0..60."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        aligned = bool(rng.random() < 0.9)
        out.append(cls(aligned=aligned, mapq=int(rng.integers(0, 61)),
                       second=int(rng.integers(-40, 0))
                       if rng.random() < 0.3 else None))
    return out


def _mapping_stats(stats_mod, result_cls):
    st = stats_mod.MappingStats()
    for k in range(3):
        st.observe(_map_results(result_cls, 10 + k))
    st.proper_pairs, st.discordant = 700, 12
    st.locate_dropped, st.overflowed, st.escalated = 5, 3, 6
    for name, total in (("total", 2.5), ("compute", 2.0), ("output", 0.25)):
        with st.timer(name):  # a real Timer, its total then set by hand
            pass
        st.timer(name).total = total
    return st


def test_mapping_stats_copy_matches():
    """MappingStats over seeded lists of the port's MapResult and of the
    reference's: summary() equal without its timing keys, report() and
    html() equal with the timers' totals set by hand."""
    from nvbio_tpu.models.mapper import MapResult as RefResult
    from nvbio_tpu_torch.models.mapper import MapResult as PortResult

    got = _mapping_stats(port_stats, PortResult)
    want = _mapping_stats(ref_stats, RefResult)
    gs, ws = got.summary(), want.summary()
    for k in ("reads_per_sec", "stage_seconds"):
        gs.pop(k), ws.pop(k)
    assert gs == ws and gs["reads"] == 1500 and len(gs["mapq_hist"]) == 5
    assert got.report() == want.report()
    assert got.html(title="t & <u>") == want.html(title="t & <u>")
    assert got.elapsed == want.elapsed == 4.75
    assert got.timer("total").count == 1


def test_html_copy_matches():
    rows = [("a", 1), ("<b>", 2.5), ("c", "x&y")]
    bars = [("q0", 3), ("q10", 0), ("q20", 7.25)]
    for mod_args in ((rows,), (rows, ("k", "v"))):
        assert port_html.table(*mod_args) == ref_html.table(*mod_args)
    assert port_html.bar_chart(bars, unit=" s") == ref_html.bar_chart(
        bars, unit=" s")
    assert port_html.bar_chart([]) == ref_html.bar_chart([])
    sections = [("S", port_html.table(rows))]
    assert port_html.page("T", sections) == ref_html.page("T", sections)


@pytest.fixture(scope="module")
def shard_fastqs(tmp_path_factory):
    """tests/test_distributed.py:22-63's inputs: 101 simulated reads, and
    40 records whose quality lines start with '@'."""
    d = tmp_path_factory.mktemp("dist")
    genome = ref_simulate.random_genome(60_000, seed=31)
    sim = ref_simulate.simulate_reads(genome, 101, 100, seed=32)
    from nvbio_tpu.io.fastq import write_fastq

    write_fastq(str(d / "reads.fq"), [
        (f"read_{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(101)])
    with open(d / "tricky.fq", "w") as f:
        for i in range(40):
            f.write(f"@r{i}\nACGTACGTAC\n+\n@@@@@@@@@@\n")
    return d


@pytest.mark.parametrize("name,n_shards", [
    ("reads.fq", 2), ("reads.fq", 3), ("reads.fq", 7), ("tricky.fq", 2),
    ("tricky.fq", 3), ("tricky.fq", 5)])
def test_shard_fastq_copy_matches(shard_fastqs, name, n_shards):
    path = str(shard_fastqs / name)
    ranges = port_dist.shard_fastq(path, n_shards)
    _equal(ranges, ref_dist.shard_fastq(path, n_shards))
    for s, e in ranges:
        _equal(port_dist.read_fastq_range(path, s, e),
               ref_dist.read_fastq_range(path, s, e))


@pytest.mark.parametrize("ext", [".sam", ".sam.gz"])
def test_merge_sam_shards_copy_matches(tmp_path, ext):
    rng = np.random.default_rng(9)
    shards = []
    for k in range(3):
        sp = tmp_path / f"s{k}{ext}"
        lines = ["@HD\tVN:1.6\n", f"@PG\tID:x\tCL:shard {k}\n"] + [
            f"r{k}_{i}\t0\tc\t{int(rng.integers(1, 999))}\t40\t10M\n"
            for i in range(int(rng.integers(0, 6)))]
        with (gzip.open(sp, "wt") if ext.endswith(".gz") else open(sp, "w")
              ) as f:
            f.writelines(lines)
        shards.append(str(sp))

    def merged(mod, tag):
        out = tmp_path / f"{tag}{ext}"
        n = mod.merge_sam_shards(shards, str(out))
        with (gzip.open(out, "rb") if ext.endswith(".gz") else open(out, "rb")
              ) as f:
            return n, f.read()

    assert merged(port_dist, "port") == merged(ref_dist, "ref")


@pytest.mark.parametrize("port,ref", [(port_bwa, ref_bwa),
                                      (port_blosum, ref_blosum),
                                      (port_cigar, ref_cigar),
                                      (port_oracle, ref_oracle)],
                         ids=["io.bwa_files", "alignment.blosum",
                              "alignment.cigar", "alignment.oracle"])
def test_whole_module_copies_are_the_reference(port, ref):
    """io/bwa_files.py, alignment/blosum.py, alignment/cigar.py and
    alignment/oracle.py are NumPy only: whole copies, line for line."""
    assert inspect.getsource(port) == inspect.getsource(ref)


def test_bwa_files_copy_round_trips_as_reference(tmp_path):
    """write/read of .bwt, .sa, .ann, .amb and .pac: the same bytes and
    the same parsed values from both packages."""
    rng = np.random.default_rng(12)
    syms = rng.integers(0, 4, 1_003).astype(np.uint8)
    sa = rng.integers(0, 1_003, 31).astype(np.int64)
    L2 = np.cumsum(np.bincount(syms, minlength=4))
    for tag, mod, idx in (("p", port_bwa, port_index_file),
                          ("r", ref_bwa, ref_index_file)):
        mod.write_bwt(tmp_path / f"{tag}.bwt", syms, 17, None)
        mod.write_sa(tmp_path / f"{tag}.sa", sa, 32, 17, L2, 1_003)
        mod.write_ann(tmp_path / f"{tag}.ann", 1_003, ["a", "b"],
                      [600, 403], [1, 0])
        mod.write_amb(tmp_path / f"{tag}.amb", 1_003, 2, [(5, 3, "N")])
        idx.write_pac(tmp_path / f"{tag}.pac", syms)
    for ext, read in ((".bwt", "read_bwt"), (".sa", "read_sa"),
                      (".ann", "read_ann"), (".amb", "read_amb")):
        assert ((tmp_path / f"p{ext}").read_bytes()
                == (tmp_path / f"r{ext}").read_bytes())
        _equal(getattr(port_bwa, read)(tmp_path / f"p{ext}"),
               getattr(ref_bwa, read)(tmp_path / f"r{ext}"))
    assert (tmp_path / "p.pac").read_bytes() == (tmp_path / "r.pac").read_bytes()
    _equal(port_index_file.read_pac(tmp_path / "p.pac"),
           ref_index_file.read_pac(tmp_path / "r.pac"))
    _equal(port_index_file.read_pac(tmp_path / "p.pac"), syms)
