"""The port's build_index suffix-sort and occ options and its set_bwt CLI
against the JAX package's CLIs on the CPU: ``build_index --device cpu``
with --algorithm auto, sais, pd and device (whole-text doubling, and the
bucketed sort with the port's size threshold lowered), with
--device-occ, and with --accelerator, each ``.npz`` equal to the
reference CLI's key by key; ``--shard-bp --device-occ --device cpu``
equal to the reference's manifest build; ``set_bwt --device cpu`` to
``.npy`` and ``.txt`` equal to ``nvbio_tpu.tools.set_bwt --cpu``; and a
device stage with ``--device cuda`` on a machine without CUDA raising
resolve_device's error, while a host build with the default --device
still runs."""

import json

import numpy as np
import pytest
import torch

from nvbio_tpu.io.fasta import write_fasta
from nvbio_tpu.io.fastq import write_fastq
from nvbio_tpu.utils.simulate import random_genome, simulate_reads

N_BP = 300_000


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as the other port tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 300 kb genome in two contigs with an N run, and 300 reads of up
    to 100 bp (N bases and lengths below 100 among them)."""
    d = tmp_path_factory.mktemp("index_cli")
    g = random_genome(N_BP, seed=81)
    g[150_000:150_040] = 4  # an ambiguity run
    write_fasta(str(d / "g.fa"), [("c1", g[:120_000]), ("c2", g[120_000:])])
    sim = simulate_reads(g[:120_000], 300, 100, seed=82)
    rng = np.random.default_rng(83)
    recs = []
    for i in range(300):
        seq = sim["seqs"][i].astype(np.uint8)[: int(rng.integers(60, 101))]
        seq[rng.random(len(seq)) < 0.01] = 4
        recs.append((f"r{i}", seq, sim["quals"][i][: len(seq)]))
    write_fastq(str(d / "r.fq"), recs)
    return d


def _npz_equal(got, want):
    with np.load(got) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


CASES = {
    "auto": [],
    "sais": ["--algorithm", "sais"],
    "pd": ["--algorithm", "pd"],
    "device": ["--algorithm", "device"],
    "device-bucketed": ["--algorithm", "device"],
    "device-occ": ["--device-occ"],
    "device-device-occ": ["--algorithm", "device", "--device-occ"],
    "accelerator": ["--accelerator", "--sa-mono"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_index_equals_reference(data, case, monkeypatch, capsys):
    from nvbio_tpu.tools.build_index import main as ref_build
    from nvbio_tpu_torch.tools import build_index

    if case == "device-bucketed":  # the shard-scale sort on a small text
        monkeypatch.setattr(build_index, "DEVICE_PD_MAX_BP", 0)
    flags = ["--lut-k", "8", "--sa-sample", "8", *CASES[case]]
    out = data / case
    out.mkdir()
    assert build_index.main([str(data / "g.fa"), str(out / "port.npz"),
                             *flags, "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    alg = CASES[case][1] if CASES[case][:1] == ["--algorithm"] else None
    if alg:
        assert f"[build_index] suffix sort ({alg}): " in captured.err
    assert ("[sufsort] chunk" in captured.out) == (case == "device-bucketed")
    assert ref_build([str(data / "g.fa"), str(out / "ref.npz"),
                      *flags]) == 0
    _npz_equal(out / "port.npz", out / "ref.npz")


def test_sharded_device_occ_equals_reference(data):
    from nvbio_tpu.tools.build_index import main as ref_build
    from nvbio_tpu_torch.tools.build_index import main as port_build

    flags = ["--lut-k", "8", "--shard-bp", "100000", "--shard-overlap",
             "1024", "--procs", "1", "--device-occ", "--algorithm", "pd"]
    port, ref = data / "sharded_port", data / "sharded_ref"
    port.mkdir()
    ref.mkdir()
    assert port_build([str(data / "g.fa"), str(port / "sh"), *flags,
                       "--device", "cpu"]) == 0
    assert ref_build([str(data / "g.fa"), str(ref / "sh"), *flags]) == 0
    man = json.load(open(port / "sh.manifest.json"))
    assert man == json.load(open(ref / "sh.manifest.json"))
    assert len(man["shards"]) == 3
    for i in range(3):
        _npz_equal(port / f"sh.shard{i}.npz", ref / f"sh.shard{i}.npz")
    np.testing.assert_array_equal(np.load(port / "sh.genome.npy"),
                                  np.load(ref / "sh.genome.npy"))


@pytest.mark.parametrize("ext", [".npy", ".txt"])
def test_set_bwt_equals_reference(data, ext, capsys):
    from nvbio_tpu.tools.set_bwt import main as ref_set_bwt
    from nvbio_tpu_torch.tools.set_bwt import main as port_set_bwt

    got, want = data / f"port{ext}", data / f"ref{ext}"
    assert port_set_bwt([str(data / "r.fq"), str(got), "--max-len", "128",
                         "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert err.startswith("[set_bwt] 300 reads, ") and "Mbases/s" in err
    assert ref_set_bwt([str(data / "r.fq"), str(want), "--max-len", "128",
                        "--cpu"]) == 0
    assert got.read_bytes() == want.read_bytes()
    if ext == ".txt":
        text = got.read_text()
        assert text.count("$") == 300 and set(text) == set("ACGT$")


@pytest.mark.parametrize("flags", [
    ["--algorithm", "device"], ["--device-occ"],
    ["--device-occ", "--shard-bp", "100000"]],
    ids=["algorithm-device", "device-occ", "sharded-device-occ"])
def test_build_index_device_stage_needs_cuda(data, flags, tmp_path):
    from nvbio_tpu_torch.tools.build_index import main as build

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for dev in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="cuda"):
            build([str(data / "g.fa"), str(tmp_path / "x.npz"), *flags,
                   *dev])
    assert not list(tmp_path.iterdir())  # nothing was built on the host
    # the host stages ignore --device: a plain build runs without a card
    assert build([str(data / "g.fa"), str(tmp_path / "h.npz"), "--lut-k",
                  "6", "--accelerator", "--algorithm", "pd"]) == 0


def test_set_bwt_needs_cuda(data, tmp_path):
    from nvbio_tpu_torch.tools.set_bwt import main as set_bwt

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for dev in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="cuda"):
            set_bwt([str(data / "r.fq"), str(tmp_path / "b.npy"), *dev])
    assert not list(tmp_path.iterdir())
