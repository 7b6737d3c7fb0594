"""map_reads -S *.bam in the port writes BAM, as the reference does: on
the golden single-end and paired-end datasets, the port's output under
--device cpu is a BGZF file whose decompressed bytes equal those of
nvbio_tpu.tools.map_reads --cpu (the @PG header line masked, as the
golden SAM tests mask it), and whose records, read back with read_bam,
equal the golden SAM's."""

import gzip
import os
import struct

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _write_se(d):
    from nvbio_tpu.io.fasta import write_fasta
    from nvbio_tpu.io.fastq import write_fastq
    from nvbio_tpu.utils.simulate import random_genome, simulate_reads

    g = random_genome(200_000, seed=12345)
    write_fasta(str(d / "g.fa"), [("golden_ref", g)])
    sim = simulate_reads(g, 300, 100, seed=54321, error_rate=0.02,
                         indel_rate=0.005)
    write_fastq(str(d / "r.fq"), [
        (f"gr{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(300)])
    return ["-U", str(d / "r.fq")]


def _write_pe(d):
    from nvbio_tpu.io.fasta import write_fasta
    from nvbio_tpu.io.fastq import write_fastq
    from nvbio_tpu.utils.simulate import random_genome, simulate_pairs

    g = random_genome(150_000, seed=777)
    write_fasta(str(d / "g.fa"), [("golden_pe_ref", g)])
    sim = simulate_pairs(g, 120, 100, insert_mean=280, insert_sd=25,
                         error_rate=0.02, seed=778)
    for m in (1, 2):
        write_fastq(str(d / f"r{m}.fq"),
                    [(f"p{i}", sim[f"seqs{m}"][i].astype(np.uint8),
                      sim[f"quals{m}"][i]) for i in range(120)])
    return ["-1", str(d / "r1.fq"), "-2", str(d / "r2.fq")]


GOLDEN = {"se": (_write_se, "golden_se.sam.gz"),
          "pe": (_write_pe, "golden_pe.sam.gz")}


@pytest.fixture(scope="module", params=sorted(GOLDEN))
def mapped(request, tmp_path_factory):
    """One golden dataset mapped to BAM by the port (--device cpu) and
    by the reference (--cpu), on one index."""
    from nvbio_tpu.tools.map_reads import main as ref_map
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    write, golden = GOLDEN[request.param]
    d = tmp_path_factory.mktemp(request.param)
    reads = write(d)
    assert build([str(d / "g.fa"), str(d / "g.npz")]) == 0
    common = ["-x", str(d / "g.npz"), *reads, "--batch", "128"]
    assert port_map([*common, "-S", str(d / "port.bam"),
                     "--device", "cpu"]) == 0
    ref_map([*common, "-S", str(d / "ref.bam"), "--cpu"])
    return d, golden


def _blocks(raw):
    """The BGZF blocks of a file: each a gzip member with the BC extra
    field giving its size."""
    off, blocks = 0, []
    while off < len(raw):
        id1, id2, cm, flg = raw[off:off + 4]
        assert (id1, id2, cm, flg) == (0x1F, 0x8B, 8, 4)
        xlen, si1, si2, slen, bsize = struct.unpack_from("<H2BHH", raw,
                                                         off + 10)
        assert (xlen, si1, si2, slen) == (6, ord("B"), ord("C"), 2)
        blocks.append(raw[off:off + bsize + 1])
        off += bsize + 1
    assert off == len(raw)
    return blocks


def _masked(path):
    """The decompressed BAM with the @PG line cut from its header text
    (the header's length field follows the cut)."""
    raw = gzip.open(path, "rb").read()
    assert raw[:4] == b"BAM\x01"
    (l_text,) = struct.unpack_from("<i", raw, 4)
    text = raw[8:8 + l_text].decode()
    kept = "".join(ln for ln in text.splitlines(keepends=True)
                   if not ln.startswith("@PG"))
    return kept, raw[8 + l_text:]


def test_port_writes_bgzf(mapped):
    d, _ = mapped
    raw = (d / "port.bam").read_bytes()
    blocks = _blocks(raw)
    assert len(blocks) >= 2 and blocks[-1] == BGZF_EOF
    # every block is a whole gzip member of at most 64 KiB
    assert all(len(gzip.decompress(b)) <= 0x10000 for b in blocks)


def test_port_bam_equals_reference_bam(mapped):
    d, _ = mapped
    assert _masked(d / "port.bam") == _masked(d / "ref.bam")


def _sam_as_bam_record(line, names):
    f = line.rstrip("\n").split("\t")
    tags = {}
    for t in f[11:]:
        tag, ty, val = t.split(":", 2)
        tags[tag] = int(val) if ty == "i" else val
    return {"qname": f[0], "flag": int(f[1]),
            "ref_id": names.index(f[2]) if f[2] != "*" else -1,
            "pos": int(f[3]) - 1, "mapq": int(f[4]), "cigar": f[5],
            "seq": f[9], "qual": f[10], "tlen": int(f[8]),
            "next_pos": int(f[7]) - 1, "tags": tags}


def test_port_bam_records_equal_golden_sam(mapped):
    from nvbio_tpu_torch.io.bam import read_bam

    d, golden = mapped
    text, names, recs = read_bam(str(d / "port.bam"))
    lines = list(gzip.open(os.path.join(DATA, golden), "rt"))
    head = [ln for ln in lines if ln.startswith("@")]
    assert [ln for ln in text.splitlines(keepends=True)
            if not ln.startswith("@PG")] == head
    want = [_sam_as_bam_record(ln, names) for ln in lines
            if not ln.startswith("@")]
    assert len(recs) == len(want) and recs == want


def test_sam_paths_still_write_text(tmp_path):
    """-S *.sam writes plain text and -S *.sam.gz gzip text, the same
    records either way."""
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    reads = _write_se(tmp_path)
    assert build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")]) == 0
    common = ["-x", str(tmp_path / "g.npz"), *reads, "--batch", "128",
              "--device", "cpu"]
    assert port_map([*common, "-S", str(tmp_path / "o.sam")]) == 0
    assert port_map([*common, "-S", str(tmp_path / "o.sam.gz")]) == 0
    text = (tmp_path / "o.sam").read_text()
    assert text.startswith("@HD\t")
    # the @PG line's CL: holds the output path, which differs
    unpg = [ln for ln in gzip.open(tmp_path / "o.sam.gz", "rt")
            if not ln.startswith("@PG")]
    assert unpg == [ln for ln in text.splitlines(keepends=True)
                    if not ln.startswith("@PG")]
    assert len(unpg) == 300 + 2
