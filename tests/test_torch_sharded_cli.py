"""build_index --shard-bp and map_reads on the manifest, against the JAX
package's CLI on the CPU: on the golden SE and PE datasets
(tests/test_torch_bam.py), each with a sharded index built by the port's
build_index (3 shards; worker processes for one of them),
``nvbio_tpu_torch.tools.map_reads --device cpu`` and
``nvbio_tpu.tools.map_reads --cpu`` give byte-equal SAM (@PG masked) and
the same non-timing --stats keys for SE, PE, SE --local -N 1, SE -a
--max-alns 3 and SE with --mesh off --fm2-mode stream; the reference's
build_index output maps alike in the port."""

import json

import pytest
import torch

from test_torch_bam import _write_pe, _write_se

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
    """The golden SE (200 kb) and PE (150 kb) datasets, each with a
    3-shard index built by the port (the SE one by two workers)."""
    from nvbio_tpu_torch.tools.build_index import main as build

    out = {}
    for name, write, bp, procs in (("se", _write_se, "70000", "2"),
                                   ("pe", _write_pe, "60000", "1")):
        d = tmp_path_factory.mktemp(name)
        reads = write(d)
        assert build([str(d / "g.fa"), str(d / "g.npz"), "--shard-bp", bp,
                      "--shard-overlap", "2048", "--procs", procs]) == 0
        assert len(json.load(open(d / "g.manifest.json"))["shards"]) == 3
        out[name] = (d, reads)
    return out


def _sam(path):
    return [ln for ln in open(path) if not ln.startswith("@PG")]


CASES = [("se", []), ("pe", []), ("se", ["--local", "-N", "1"]),
         ("se", ["-a", "--max-alns", "3"]),
         ("se", ["--mesh", "off", "--fm2-mode", "stream"])]


@pytest.mark.parametrize("data,flags", CASES,
                         ids=["se", "pe", "se-local-N1", "se-all3",
                              "se-fm2-stream"])
def test_sharded_sam_equals_reference(golden, data, flags):
    from nvbio_tpu.tools.map_reads import main as ref_map
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    d, reads = golden[data]
    common = ["-x", str(d / "g.manifest.json"), *reads, "--batch", "128",
              *flags]
    assert port_map([*common, "-S", str(d / "port.sam"), "--device", "cpu",
                     "--stats", str(d / "port.json")]) == 0
    # the test session gives JAX several CPU devices, where the
    # reference's --mesh auto would take its shard-per-device mesh
    ref_map([*common, "-S", str(d / "ref.sam"), "--cpu", "--stats",
             str(d / "ref.json"), "--mesh", "off"])
    got = _sam(d / "port.sam")
    assert got == _sam(d / "ref.sam")
    recs = [ln.split("\t") for ln in got if not ln.startswith("@")]
    assert sum(not int(r[1]) & 4 for r in recs) > 0.9 * len(recs)
    want = json.load(open(d / "ref.json"))
    stats = json.load(open(d / "port.json"))
    for k in want:
        if k not in TIMING_KEYS:
            assert stats[k] == want[k], k
    if data == "pe":
        assert stats["pairs"] == 120 and stats["rescue_dropped"] == 0


def test_reference_built_index_maps_alike(golden, tmp_path):
    """nvbio_tpu.tools.build_index --shard-bp writes files the port maps
    to the same SAM as it maps its own build."""
    from nvbio_tpu.tools.build_index import main as ref_build
    from nvbio_tpu_torch.tools.map_reads import main as port_map

    d, reads = golden["se"]
    ref_build([str(d / "g.fa"), str(tmp_path / "r.npz"), "--shard-bp",
               "70000", "--shard-overlap", "2048", "--procs", "1"])
    ref_man = json.load(open(tmp_path / "r.manifest.json"))
    port_man = json.load(open(d / "g.manifest.json"))
    for man in (ref_man, port_man):
        for e in man["shards"]:
            e.pop("file")
    assert ref_man == port_man
    for x, out in ((tmp_path / "r.manifest.json", tmp_path / "a.sam"),
                   (d / "g.manifest.json", tmp_path / "b.sam")):
        assert port_map(["-x", str(x), *reads, "--batch", "128", "-S",
                         str(out), "--device", "cpu"]) == 0
    assert _sam(tmp_path / "a.sam") == _sam(tmp_path / "b.sam")
