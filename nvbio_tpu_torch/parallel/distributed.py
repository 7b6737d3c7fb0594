"""Multi-host input sharding, the process group and the SAM merge.

A copy of ``shard_fastq``, ``read_fastq_range`` and ``merge_sam_shards``
from ``nvbio_tpu/parallel/distributed.py`` for the PyTorch port
(package-relative imports only), which imports nothing of
``nvbio_tpu``, and the port of its ``init_distributed``:

- every process calls :func:`init_distributed`, which joins a
  ``torch.distributed`` process group (NCCL on cards, gloo on the CPU;
  the counterpart of the reference's ``jax.distributed``);
- each host reads only its own record-aligned byte range of the FASTQ
  (:func:`shard_fastq`, :func:`read_fastq_range`; ``map_reads
  --num-shards/--shard-id``);
- shard k writes SAM records in its input order, and
  :func:`merge_sam_shards` concatenates the shards in shard order, so the
  merged record order equals a single run's (``sam_merge``).
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device: str = "cuda"):
    """Join the process group from the arguments or the environment
    (COORDINATOR_ADDRESS as host:port, NUM_PROCESSES, PROCESS_ID), with
    NCCL for ``device`` "cuda" and gloo for "cpu", the address, world
    size and rank given explicitly; returns (rank, world_size).  On
    "cuda" the process first binds to its card: LOCAL_RANK where it is
    set, else its rank modulo the host's card count (the card NCCL's
    collectives and ``torch.device("cuda")`` then name).  Does nothing
    in a single process: (0, 1)."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return 0, 1
    if process_id is None:
        process_id = int(os.environ["PROCESS_ID"])
    if not coordinator:
        raise ValueError("init_distributed needs a coordinator host:port "
                         "(argument or COORDINATOR_ADDRESS)")
    import torch.distributed as dist

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def shard_fastq(path: str, num_shards: int):
    """Byte ranges [(start, end)) splitting a FASTQ into record-aligned
    shards — each host reads only its range (no cross-host input).

    Boundaries snap forward to the next record start (an '@' line whose
    following structure matches FASTQ's 4-line framing, disambiguated
    from '@' inside quality strings by checking the '+' separator two
    lines down).
    """
    size = os.path.getsize(path)
    if num_shards <= 1:
        return [(0, size)]
    approx = size // num_shards
    cuts = [0]
    with open(path, "rb") as f:
        for k in range(1, num_shards):
            target = k * approx
            f.seek(target)
            f.readline()  # finish the partial line
            # scan forward to a verified record start
            while True:
                pos = f.tell()
                line = f.readline()
                if not line:
                    pos = size
                    break
                if line.startswith(b"@"):
                    f.readline()  # sequence
                    plus = f.readline()
                    if plus.startswith(b"+"):
                        break
                    f.seek(pos + len(line))
            cuts.append(pos)
    cuts.append(size)
    # degenerate shards (empty range) are fine: no records
    return [(cuts[i], cuts[i + 1]) for i in range(num_shards)]


def read_fastq_range(path: str, start: int, end: int):
    """Parse the FASTQ records fully contained in [start, end) ->
    (names, seqs, quals) lists, same types as io.fastq.read_fastq."""
    from ..basic.alphabet import char_to_dna

    names, seqs, quals = [], [], []
    with open(path, "rb") as f:
        f.seek(start)
        while f.tell() < end:
            h = f.readline()
            if not h or not h.startswith(b"@"):
                break
            s = f.readline().strip()
            f.readline()  # +
            q = f.readline().strip()
            names.append(h[1:].split()[0].decode())
            seqs.append(char_to_dna(np.frombuffer(s, dtype=np.uint8)))
            quals.append(np.frombuffer(q, dtype=np.uint8) - 33)
    return names, seqs, quals


def merge_sam_shards(shard_paths: list[str], out_path: str):
    """Ordered merge: header from shard 0, records concatenated in
    shard order.  Because shards partition the input in order and each
    mapper writes records in input order, the merged file's record
    order equals the single-run record order (deterministic multi-host
    output, SURVEY.md §7.3(6))."""
    import gzip

    def _open(p, mode):
        return gzip.open(p, mode) if str(p).endswith(".gz") else open(p, mode)

    n_records = 0
    with _open(out_path, "wt") as out:
        for k, sp in enumerate(shard_paths):
            with _open(sp, "rt") as f:
                for line in f:
                    if line.startswith("@"):
                        if k == 0:
                            out.write(line)
                        continue
                    out.write(line)
                    n_records += 1
    return n_records
