"""map_reads' input and output options and the host CLIs of the port,
against the JAX package on the CPU, exact equality throughout.

On the golden single-end and paired-end datasets (tests/test_torch_bam.py)
with an index built by the port, ``nvbio_tpu_torch.tools.map_reads
--device cpu`` and ``nvbio_tpu.tools.map_reads --cpu`` run with the same
flags: SE with Phred+64 input, PE with Solexa+64 input and SE ``-a
--max-alns 4``, each with ``--un/--al`` (one of them gzipped),
``--rg-id/--rg``, ``--stats`` and ``--html``.  The SAM (@PG masked), the
``--un``/``--al`` bytes, every stats key but the two timing ones and the
HTML outside its timing rows are equal.  ``--resume`` and
``--num-shards/--shard-id`` + ``sam_merge`` give an uninterrupted single
run's records; ``aln_diff`` and ``extract_reads`` equal the reference
tools; ``--xprof`` writes a Chrome trace."""

import gzip
import json
import os
import re

import numpy as np
import pytest
import torch

from test_torch_bam import _write_pe, _write_se

DATA = os.path.join(os.path.dirname(__file__), "data")
#: the port's keys beside the reference's MappingStats summary
PORT_KEYS = {"device", "load_s", "map_s", "reads_per_s"}
PORT_PE_KEYS = PORT_KEYS | {"pairs", "pairs_per_s", "rescued",
                            "rescue_dropped"}
TIMING_KEYS = ("reads_per_sec", "stage_seconds")


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


def _shift_quals(src, dst, by=31):
    """A FASTQ with every quality byte raised by ``by`` (Phred+33 ->
    Phred+64, or Solexa+64 read the same way)."""
    lines = open(src).read().split("\n")
    for i in range(3, len(lines), 4):
        lines[i] = "".join(chr(ord(c) + by) for c in lines[i])
    open(dst, "w").write("\n".join(lines))
    return str(dst)


def _sam(path):
    return [ln for ln in open(path) if not ln.startswith("@PG")]


def _records(path):
    return [ln for ln in open(path) if not ln.startswith("@")]


def _fq_bytes(path):
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rb") as f:
        return f.read()


def _html_parts(text):
    """An HTML report without its timing: the page up to the stage
    chart with the reads_per_sec row removed, and the chart's labels."""
    head, stages = text.split("<h2>Stage timing</h2>")
    head = re.sub(r"<tr><td>reads_per_sec</td><td>[^<]*</td></tr>", "",
                  head)
    return head, re.findall(r"<tr><td>([^<]*)</td>", stages)


def _both(d, common):
    """map_reads of the port (--device cpu) and of the reference (--cpu)
    with the same flags, each writing its outputs under its own prefix
    in ``d``; returns the two prefixes."""
    from nvbio_tpu.tools.map_reads import main as ref_map
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    out = []
    for tag, run, dev in (("port", port_map, ["--device", "cpu"]),
                          ("ref", ref_map, ["--cpu"])):
        pre = str(d / tag)
        rc = run([*common, "-S", f"{pre}.sam", "--un", f"{pre}.un.fq.gz",
                  "--al", f"{pre}.al.fq", "--stats", f"{pre}.json",
                  "--html", f"{pre}.html", *dev])
        assert rc in (0, None)
        out.append(pre)
    return out


def _assert_outputs_equal(port, ref, extra_keys):
    assert _sam(f"{port}.sam") == _sam(f"{ref}.sam")
    for ext in ("un.fq.gz", "al.fq"):
        assert _fq_bytes(f"{port}.{ext}") == _fq_bytes(f"{ref}.{ext}"), ext
    got, want = (json.load(open(f"{p}.json")) for p in (port, ref))
    assert set(got) == set(want) | extra_keys
    for k in want:
        if k not in TIMING_KEYS:
            assert got[k] == want[k], k
    assert list(got["stage_seconds"]) == list(want["stage_seconds"])
    assert (_html_parts(open(f"{port}.html").read())
            == _html_parts(open(f"{ref}.html").read()))
    return got


def _fq_records(path):
    lines = _fq_bytes(path).decode().split("\n")
    return [tuple(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]


def _fq_names(path):
    return [rec[0][1:] for rec in _fq_records(path)]


@pytest.fixture(scope="module")
def se_run(golden, tmp_path_factory):
    d0, reads = golden["se"]
    d = tmp_path_factory.mktemp("se_flags")
    fq = _shift_quals(reads[1], d / "r64.fq")
    common = ["-x", str(d0 / "g.npz"), "-U", fq, "--batch", "128",
              "--phred64", "--rg-id", "g", "--rg", "SM:a", "--rg",
              "PL:ILLUMINA"]
    return (*_both(d, common), reads[1])


def test_se_flags_equal_reference(se_run):
    """SE, Phred+64 input, --un (gzip) --al --rg-id --rg --stats
    --html: every output equals the reference's; with the RG tag
    stripped the records are the golden SAM's (a Phred+33 run)."""
    port, ref, plain_fq = se_run
    stats = _assert_outputs_equal(port, ref, PORT_KEYS)
    head = [ln for ln in open(f"{port}.sam") if ln.startswith("@")]
    assert "@RG\tID:g\tSM:a\tPL:ILLUMINA\n" in head
    recs = _records(f"{port}.sam")
    assert all(ln.endswith("\tRG:Z:g\n") for ln in recs)
    golden = [ln for ln in gzip.open(os.path.join(DATA, "golden_se.sam.gz"),
                                     "rt") if not ln.startswith("@")]
    assert [ln.replace("\tRG:Z:g\n", "\n") for ln in recs] == golden
    unmapped = [ln.split("\t", 1)[0] for ln in recs
                if int(ln.split("\t")[1]) & 4]
    mapped = [ln.split("\t", 1)[0] for ln in recs
              if not int(ln.split("\t")[1]) & 4]
    assert _fq_names(f"{port}.un.fq.gz") == unmapped
    assert _fq_names(f"{port}.al.fq") == mapped
    assert stats["reads"] == 300 and stats["aligned"] == len(mapped)
    assert sum(stats["mapq_hist"].values()) == stats["aligned"]
    # --un/--al hold the input records, qualities as Phred+33
    plain = _fq_records(plain_fq)
    routed = _fq_records(f"{port}.un.fq.gz") + _fq_records(f"{port}.al.fq")
    assert sorted(routed) == sorted(plain)


def test_pe_flags_equal_reference(golden, tmp_path):
    """PE, Solexa+64 input, --un/--al --rg-id --stats --html: every
    output equals the reference's; mates go into one file per outcome
    with /1 and /2 suffixes, both under mate 1's names."""
    d0, reads = golden["pe"]
    m1 = _shift_quals(reads[1], tmp_path / "r1.fq")
    m2 = _shift_quals(reads[3], tmp_path / "r2.fq")
    common = ["-x", str(d0 / "g.npz"), "-1", m1, "-2", m2, "--batch",
              "128", "--solexa-quals", "--rg-id", "pe"]
    port, ref = _both(tmp_path, common)
    stats = _assert_outputs_equal(port, ref, PORT_PE_KEYS)
    recs = _records(f"{port}.sam")
    assert len(recs) == 240 and all(ln.endswith("\tRG:Z:pe\n")
                                    for ln in recs)
    names = _fq_names(f"{port}.un.fq.gz") + _fq_names(f"{port}.al.fq")
    assert sum(n.endswith("/1") for n in names) == 120
    assert sum(n.endswith("/2") for n in names) == 120
    assert stats["pairs"] == 120 and stats["reads"] == 240


def test_all_mode_flags_equal_reference(golden, tmp_path):
    """SE -a --max-alns 4 with --un/--al: the outputs equal the
    reference's, RG:Z on secondary records too."""
    d0, reads = golden["se"]
    common = ["-x", str(d0 / "g.npz"), *reads, "--batch", "128", "-a",
              "--max-alns", "4", "--rg-id", "all"]
    port, ref = _both(tmp_path, common)
    _assert_outputs_equal(port, ref, PORT_KEYS)
    recs = _records(f"{port}.sam")
    assert any(int(ln.split("\t")[1]) & 0x100 for ln in recs)
    assert all(ln.endswith("\tRG:Z:all\n") for ln in recs)


def test_resume_equals_uninterrupted_run(golden, tmp_path):
    """--resume (tests/test_tools.py:186's twin): a run cut after 192
    reads, resumed against all 300, writes the uninterrupted run's
    records."""
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    d0, reads = golden["se"]
    common = ["-x", str(d0 / "g.npz"), "--batch", "64", "--device", "cpu"]
    full, part = tmp_path / "full.sam", tmp_path / "part.sam"
    assert port_map([*common, *reads, "-S", str(full)]) == 0
    lines = open(reads[1]).read().split("\n")
    open(tmp_path / "r192.fq", "w").write("\n".join(lines[:4 * 192]) + "\n")
    assert port_map([*common, "-U", str(tmp_path / "r192.fq"), "-S",
                     str(part)]) == 0
    assert len(_records(part)) == 192
    assert port_map([*common, *reads, "-S", str(part), "--resume"]) == 0
    assert _records(part) == _records(full)


@pytest.mark.parametrize("flags,message", [
    (["-U", "r.fq", "-S", "o.sam.gz", "--resume"], "--resume supports"),
    (["-U", "r.fq", "-S", "o.bam", "--resume"], "--resume supports"),
    (["-1", "r1.fq", "-2", "r2.fq", "-S", "o.sam", "--resume"],
     "--resume supports"),
    (["-U", "r.fq", "-S", "o.sam", "--rg", "SM:a"], "--rg needs --rg-id"),
], ids=["resume-gz", "resume-bam", "resume-pe", "rg-without-id"])
def test_map_reads_flag_errors(flags, message, capsys):
    """The reference's refusals, as argparse errors (exit code 2)."""
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    with pytest.raises(SystemExit) as e:
        port_map(["-x", "x.npz", *flags, "--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_shards_merge_to_the_single_run(golden, tmp_path):
    """--num-shards 2 on both shard ids then sam_merge: the port's merged
    SAM equals its single run and the reference's merged run
    (tests/test_distributed.py:66's twin)."""
    from nvbio_tpu.tools import map_reads as ref_cli
    from nvbio_tpu.tools import sam_merge as ref_merge
    from nvbio_tpu_torch.tools import map_reads as port_cli
    from nvbio_tpu_torch.tools import sam_merge as port_merge

    d0, reads = golden["se"]
    common = ["-x", str(d0 / "g.npz"), *reads, "--batch", "128"]
    single = tmp_path / "single.sam"
    assert port_cli.main([*common, "-S", str(single), "--device",
                          "cpu"]) == 0
    merged = {}
    for tag, cli, merge, dev in (
            ("port", port_cli, port_merge, ["--device", "cpu"]),
            ("ref", ref_cli, ref_merge, ["--cpu"])):
        shards = [str(tmp_path / f"{tag}{k}.sam") for k in range(2)]
        for k, sp in enumerate(shards):
            cli.main([*common, "-S", sp, "--num-shards", "2", "--shard-id",
                      str(k), *dev])
        assert 0 < len(_records(shards[0])) < 300
        merged[tag] = tmp_path / f"{tag}_merged.sam"
        assert merge.main([*shards, "-o", str(merged[tag])]) == 0
    assert _sam(merged["port"]) == _sam(single)
    assert _sam(merged["port"]) == _sam(merged["ref"])


def test_aln_diff_equals_reference(se_run, tmp_path, capsys):
    """aln_diff --pos-tolerance --json --html on two SAMs that differ
    (the flagged SE run against the golden SAM with every third record
    moved and re-scored): report, HTML, stdout and exit code equal the
    reference tool's."""
    from nvbio_tpu.tools import aln_diff as ref_tool
    from nvbio_tpu_torch.tools import aln_diff as port_tool

    port, _, _ = se_run
    moved = tmp_path / "moved.sam.gz"
    with gzip.open(os.path.join(DATA, "golden_se.sam.gz"), "rt") as src, \
            gzip.open(moved, "wt") as dst:
        for i, ln in enumerate(src):
            c = ln.split("\t")
            if not ln.startswith("@") and i % 3 == 0 and c[3] != "0":
                c[3] = str(int(c[3]) + i % 7)
                c[4] = str(max(0, int(c[4]) - i % 11))
            dst.write("\t".join(c))
    out = {}
    for tag, tool in (("port", port_tool), ("ref", ref_tool)):
        rc = tool.main([f"{port}.sam", str(moved), "--pos-tolerance", "3",
                        "--json", str(tmp_path / f"{tag}.json"), "--html",
                        str(tmp_path / f"{tag}.html")])
        out[tag] = (rc, capsys.readouterr().out,
                    open(tmp_path / f"{tag}.json").read(),
                    open(tmp_path / f"{tag}.html").read())
    assert out["port"] == out["ref"]
    report = json.loads(out["port"][2])
    assert out["port"][0] == 1 and report["stats"]["same_pos"] > 0
    assert len(report["mapq_delta_hist"]) > 1


def test_extract_reads_equals_reference(golden, tmp_path):
    """extract_reads: the .npz arrays (reads, lens, quals, names) equal
    the reference tool's, truncation included."""
    from nvbio_tpu.tools.extract_reads import main as ref_tool
    from nvbio_tpu_torch.tools.extract_reads import main as port_tool

    _, reads = golden["se"]
    for tag, tool in (("port", port_tool), ("ref", ref_tool)):
        assert tool([reads[1], str(tmp_path / f"{tag}.npz"),
                     "--max-read-len", "96"]) == 0
    got, want = (np.load(tmp_path / f"{t}.npz") for t in ("port", "ref"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (want["lens"] == 96).any()


def test_xprof_writes_a_chrome_trace(golden, tmp_path):
    """--xprof DIR creates DIR and writes a torch.profiler Chrome trace
    of the mapping loop (CPU activity here)."""
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    d0, reads = golden["se"]
    lines = open(reads[1]).read().split("\n")
    open(tmp_path / "r64.fq", "w").write("\n".join(lines[:4 * 64]) + "\n")
    trace_dir = tmp_path / "prof" / "run1"
    assert port_map(["-x", str(d0 / "g.npz"), "-U", str(tmp_path / "r64.fq"),
                     "-S", str(tmp_path / "o.sam"), "--device", "cpu",
                     "--batch", "64", "--xprof", str(trace_dir)]) == 0
    files = os.listdir(trace_dir)
    assert files == ["map_reads.trace.json"]
    trace = json.load(open(trace_dir / files[0]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert len(_records(tmp_path / "o.sam")) == 64
