"""The port's fm_server (``nvbio_tpu_torch/tools/fm_server.py``) on
``--device cpu``, in a thread, mirroring tests/test_fm_server.py: ping
reports the attach time; map requests amortise the attach and give the
same SAM; a bad request keeps the server alive; a sharded index is
served.  The server's SE and PE SAM equal the port's ``map_reads
--device cpu`` SAM on the same reads and the reference's ``map_reads
--cpu`` SAM, ``@PG`` masked (both CLIs at the server's seed interval,
11, the ``MapperParams`` default, where map_reads defaults to -i
S,1,1.15)."""

import os
import shutil
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from nvbio_tpu_torch.io.fasta import write_fasta
from nvbio_tpu_torch.io.fastq import write_fastq
from nvbio_tpu_torch.tools import fm_server
from nvbio_tpu_torch.utils.simulate import (random_genome, simulate_pairs,
                                            simulate_reads)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as the other port tests (the plain DP's
    small per-row ops slow down when the workers' pools fight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(index, sock, **kw):
    t = threading.Thread(target=fm_server.serve, args=(index, sock),
                         kwargs=dict(device="cpu", **kw), daemon=True)
    t.start()
    for _ in range(600):
        if os.path.exists(sock):
            return t
        time.sleep(0.1)
    raise RuntimeError("server socket never appeared")


def _short_dir():
    """A short socket directory: AF_UNIX paths stop at 108 bytes, which a
    pytest tmp_path can pass."""
    return tempfile.mkdtemp(prefix="fms")


def _data(d, n_genome, seed, n_reads, n_pairs=0):
    g = random_genome(n_genome, seed=seed)
    write_fasta(d / "g.fa", [("chr1", g)])
    sim = simulate_reads(g, n_reads, 100, seed=seed + 1, error_rate=0.01)
    write_fastq(d / "r.fq", [
        (f"s{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(n_reads)])
    if n_pairs:
        pe = simulate_pairs(g, n_pairs, 100, insert_mean=280, insert_sd=25,
                            error_rate=0.01, seed=seed + 2)
        for m in (1, 2):
            write_fastq(d / f"p{m}.fq", [
                (f"p{i}", pe[f"seqs{m}"][i].astype(np.uint8),
                 pe[f"quals{m}"][i]) for i in range(n_pairs)])
    return sim


def _body(path):
    return [ln for ln in open(path) if not ln.startswith("@PG")]


def _cli_sams(d, index, reads, tag, batch):
    """The port's and the reference's map_reads SAM on ``reads`` at the
    server's settings."""
    from nvbio_tpu.tools import map_reads as ref_map
    from nvbio_tpu_torch.tools import map_reads

    common = ["-x", str(index), *reads, "-i", "11", "--batch", str(batch),
              "--max-read-len", "128"]
    assert map_reads.main(common + ["-S", str(d / f"{tag}_port.sam"),
                                    "--device", "cpu"]) == 0
    assert ref_map.main(common + ["-S", str(d / f"{tag}_ref.sam"), "--cpu",
                                  "--mesh", "off"]) == 0
    return _body(d / f"{tag}_port.sam"), _body(d / f"{tag}_ref.sam")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from nvbio_tpu_torch.tools.build_index import main as build

    d = tmp_path_factory.mktemp("fmsrv")
    sim = _data(d, 120_000, 61, 64, n_pairs=32)
    assert build([str(d / "g.fa"), str(d / "g.npz"),
                  "--sa-sample", "16"]) == 0
    sock = os.path.join(_short_dir(), "fm.sock")
    t = _start(str(d / "g.npz"), sock, batch=64, max_read_len=128)
    yield d, sock, sim
    try:
        fm_server.request(sock, {"cmd": "stop"}, timeout=10)
    except OSError:
        pass
    t.join(timeout=30)
    shutil.rmtree(os.path.dirname(sock), ignore_errors=True)


def test_ping_reports_attach_time(served):
    _d, sock, _sim = served
    r = fm_server.request(sock, {"cmd": "ping"}, timeout=60)
    assert r["status"] == "ok" and r["device"] == "cpu"
    assert r["attach_seconds"] is not None


def test_map_requests_amortize_attach(served):
    """Two SE jobs and a PE job against the resident index: the SE SAMs
    equal each other, the port's map_reads SAM and the reference's, and
    so does the PE SAM; reads land near their simulated origins."""
    d, sock, sim = served
    attach = fm_server.request(sock, {"cmd": "ping"})["attach_seconds"]
    for name in ("o1", "o2"):
        r = fm_server.request(sock, {"cmd": "map", "u": str(d / "r.fq"),
                                     "sam": str(d / f"{name}.sam")})
        assert r["status"] == "ok" and r["reads"] == 64
        assert r["attach_seconds"] == attach  # paid once, at serve
    ok = 0
    for line in _body(d / "o2.sam"):
        c = line.split("\t")
        if not line.startswith("@") and not int(c[1]) & 4 and \
                abs(int(c[3]) - 1 - sim["true_pos"][int(c[0][1:])]) <= 8:
            ok += 1
    assert ok >= 58
    port, ref = _cli_sams(d, d / "g.npz", ["-U", str(d / "r.fq")], "se", 64)
    assert _body(d / "o1.sam") == _body(d / "o2.sam") == port == ref

    r = fm_server.request(sock, {"cmd": "map", "m1": str(d / "p1.fq"),
                                 "m2": str(d / "p2.fq"),
                                 "sam": str(d / "pe.sam")})
    assert r["status"] == "ok" and r["reads"] == 64
    port, ref = _cli_sams(d, d / "g.npz", ["-1", str(d / "p1.fq"), "-2",
                                           str(d / "p2.fq")], "pe", 64)
    assert _body(d / "pe.sam") == port == ref


def test_bad_request_keeps_server_alive(served):
    d, sock, _sim = served
    r = fm_server.request(sock, {"cmd": "map", "u": "/nonexistent.fq",
                                 "sam": str(d / "bad.sam")})
    assert r["status"] == "error"
    assert fm_server.request(sock, {"cmd": "ping"})["status"] == "ok"


def test_sharded_index_served(tmp_path):
    """The daemon serves a sharded index (ShardedMapper and
    PairedShardedMapper): its SE and PE SAM equal map_reads' on the
    manifest, the port's and the reference's."""
    from nvbio_tpu_torch.tools.build_index import main as build

    sim = _data(tmp_path, 150_000, 63, 48, n_pairs=24)
    assert build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz"),
                  "--sa-sample", "16", "--shard-bp", "60000"]) == 0
    sock = os.path.join(_short_dir(), "fm.sock")
    t = _start(str(tmp_path / "g"), sock, batch=48, max_read_len=128)
    try:
        for tag, req in (("o", {"u": str(tmp_path / "r.fq")}),
                         ("ope", {"m1": str(tmp_path / "p1.fq"),
                                  "m2": str(tmp_path / "p2.fq")})):
            r = fm_server.request(sock, {"cmd": "map", **req,
                                         "sam": str(tmp_path / f"{tag}.sam")},
                                  timeout=600)
            assert r["status"] == "ok" and r["reads"] == 48
    finally:
        fm_server.request(sock, {"cmd": "stop"}, timeout=10)
        t.join(timeout=60)
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
    ok = 0
    for line in _body(tmp_path / "o.sam"):
        c = line.split("\t")
        if not line.startswith("@") and not int(c[1]) & 4 and \
                abs(int(c[3]) - 1 - sim["true_pos"][int(c[0][1:])]) <= 8:
            ok += 1
    assert ok >= 44
    idx = tmp_path / "g.manifest.json"
    port, ref = _cli_sams(tmp_path, idx, ["-U", str(tmp_path / "r.fq")],
                          "sh", 48)
    assert _body(tmp_path / "o.sam") == port == ref
    port, ref = _cli_sams(tmp_path, idx, ["-1", str(tmp_path / "p1.fq"),
                                          "-2", str(tmp_path / "p2.fq")],
                          "shpe", 48)
    assert _body(tmp_path / "ope.sam") == port == ref
