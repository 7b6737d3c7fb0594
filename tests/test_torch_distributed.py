"""The port's ``init_distributed`` (``parallel/distributed.py``), the
counterpart of tests/test_distributed.py:97: two gloo processes join one
process group on a free local port, each maps its own record-aligned
half of a FASTQ (``shard_fastq`` + ``read_fastq_range``) on the CPU, and
they ``all_reduce`` the aligned and read counts; both report the same
global count, with at least 9 in 10 reads aligned.  The same with NCCL,
each process on its own card (marked ``cuda``; it needs two cards).  And
in a single process it does nothing.  The file imports no JAX, so it
also runs on a machine without it (``pytest --noconftest``)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from nvbio_tpu_torch.fmindex.build import build_fm_arrays
    from nvbio_tpu_torch.io.index_file import index_from_numpy
    from nvbio_tpu_torch.models import Mapper, MapperParams
    from nvbio_tpu_torch.parallel import (init_distributed,
                                          read_fastq_range, shard_fastq)
    from nvbio_tpu_torch.strings.string_set import pack_reads
    from nvbio_tpu_torch.utils.simulate import random_genome

    pid, nproc, port, fq, device = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    rank, world = init_distributed(f"127.0.0.1:{port}", nproc, pid,
                                   device=device)
    assert (rank, world) == (pid, nproc)
    if device == "cuda":  # bound to its own card before the group
        assert torch.cuda.current_device() == rank % torch.cuda.device_count()
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    # the same index in every process (replicated, as on a real cluster)
    g = random_genome(20_000, seed=11)
    fm, ssa, gi, _ = index_from_numpy(*build_fm_arrays(g, sa_sample=16), g,
                                      device=dev)
    m = Mapper(fm, ssa, gi, params=MapperParams(
        batch_size=16, sa_sample=16, max_candidates=8, lut_k=0))
    names, seqs, quals = read_fastq_range(fq, *shard_fastq(fq, world)[rank])
    reads, lens, qmat, _ = pack_reads(seqs, quals)
    res = m.map_reads(reads, lens, qmat)
    counts = torch.tensor([sum(r.aligned for r in res), len(res)],
                          device=dev)
    dist.all_reduce(counts)  # a sum over the processes
    dist.destroy_process_group()
    print(f"DIST_OK rank={rank} dev={dev} local={len(res)} "
          f"aligned={int(counts[0])}/{int(counts[1])}", flush=True)
""")


def _two_process_group(tmp_path, device):
    """Two workers on ``device`` over one process group; their outputs."""
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads

    g = random_genome(20_000, seed=11)
    sim = simulate_reads(g, 32, 64, seed=12)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, [(f"r{i}", sim["seqs"][i].astype(np.uint8),
                      sim["quals"][i]) for i in range(32)])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(k), "2", port, fq, device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
        for k in range(2)]
    outs = []
    try:
        for pr in procs:
            out, err = pr.communicate(timeout=240)
            outs.append((pr.returncode, out.decode(), err.decode()))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        assert "DIST_OK" in out
    # each maps its own half; the global counts agree
    local = [int(o.split("local=")[1].split()[0]) for _, o, _ in outs]
    assert min(local) > 0 and sum(local) == 32
    counts = {o.split("aligned=")[1].split()[0] for _, o, _ in outs}
    assert len(counts) == 1
    n_ok, n_tot = counts.pop().split("/")
    assert int(n_tot) == 32 and int(n_ok) >= int(n_tot) * 9 // 10
    return outs


def test_two_process_gloo_group_agrees(tmp_path):
    _two_process_group(tmp_path, "cpu")


@pytest.mark.cuda
def test_two_process_nccl_group_agrees(tmp_path):
    """NCCL over two cards: each rank binds to its own card, maps there
    and all-reduces a tensor on that card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (one a process)")
    outs = _two_process_group(tmp_path, "cuda")
    assert sorted(o.split("dev=")[1].split()[0] for _, o, _ in outs) == [
        "cuda:0", "cuda:1"]


def test_single_process_does_nothing(monkeypatch):
    import torch.distributed as dist

    from nvbio_tpu_torch.parallel import init_distributed

    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    assert init_distributed() == (0, 1)
    assert init_distributed(num_processes=1) == (0, 1)
    assert not dist.is_initialized()
