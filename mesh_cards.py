#!/usr/bin/env python3
"""The shard-per-device mesh of the PyTorch + CUDA port over several GPUs.

    python3 mesh_cards.py          # one host, its cards (four for 4 shards)

chip_smoke.py runs the mesh on the cards it has, usually one (every shard
on cuda:0).  This run puts shard k on card k mod the card count, so that
with four cards each shard has a card of its own, the kernels launch on
tensors of cards other than the current one, and the results cross cards:

1. chip_smoke's chr20-length genome, the first 16 384 of its reads and
   4 096 of its pairs (chip_smoke.chr20_inputs, pe_inputs), and its
   4-shard index (chip_smoke.build_shards);
2. chip_smoke.phase_mesh: MeshShardedMapper and MeshPairedShardedMapper
   beside the sequential sharded mappers (all shards on cuda:0) in the
   same process, every result equal, SE / PE / -a, launch counts,
   reads/s and pairs/s of both schedules, each shard's card and bytes;
3. map_reads --mesh auto on the manifest (the mesh wherever there are as
   many cards as shards) against --mesh off: the same SAM records;
4. tests/test_torch_distributed.py's NCCL case: two processes through
   init_distributed, each bound to its own card, all-reduce their
   aligned counts (it must pass, not skip; it needs two cards).

The card names and power limits lead the output; the numbers also go to
chiprun_out/mesh_cards/result.json.  Bulk files go to .chip_smoke_work/
(removed at the end).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "mesh_cards")


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as C
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    if not torch.cuda.is_available():
        C.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    C.log(smi)
    t_start = time.perf_counter()
    d = os.path.join(C.WORK, "chr20len")
    os.makedirs(d, exist_ok=True)
    result = {"nvidia_smi": smi.splitlines(),
              "device_count": torch.cuda.device_count()}
    try:
        g, _ = C.chr20_inputs(np, d, C.MESH_SE)
        C.pe_inputs(np, g, d, C.MESH_PAIRS)
        for m in (1, 2):
            C.head_fastq(f"{d}/pe{m}.fq", f"{d}/shpe{m}.fq", C.MESH_PAIRS)
        C.head_fastq(f"{d}/r.fq", f"{d}/sh_sub.fq", C.SHARD_CPU_READS)
        result["build_s"], result["shards"] = C.build_shards(d)
        C.log(f"[mesh_cards] genome, reads and the 4-shard index in "
              f"{time.perf_counter() - t_start:.1f}s")
        C.phase_build()
        result["mesh"] = C.phase_mesh(torch, np)

        sams = {}
        for mode in ("off", "auto"):
            t0 = time.perf_counter()
            mapr(["-x", f"{d}/sh.manifest.json", "-U", f"{d}/r.fq", "-S",
                  f"{d}/mesh_{mode}.sam", "--device", "cuda", "--batch",
                  "4096", "--mesh", mode])
            sams[mode] = C.sam_records(f"{d}/mesh_{mode}.sam")
            result[f"cli_{mode}_s"] = time.perf_counter() - t0
        if sams["auto"] != sams["off"]:
            C.fail("map_reads --mesh auto SAM differs from --mesh off")
        C.log(f"[mesh_cards] map_reads --mesh auto = --mesh off on "
              f"{len(sams['off'])} records ({result['cli_auto_s']:.1f}s, "
              f"{result['cli_off_s']:.1f}s)")

        t0 = time.perf_counter()
        nccl = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-p",
             "no:cacheprovider", "-q", "-rs",
             "tests/test_torch_distributed.py::"
             "test_two_process_nccl_group_agrees"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        result["nccl"] = nccl.stdout.strip().splitlines()[-1:]
        if nccl.returncode or not re.search(r"^1 passed\b", nccl.stdout,
                                            re.M):
            C.fail(f"the two-card NCCL group: rc {nccl.returncode}\n"
                   f"{nccl.stdout[-3000:]}\n{nccl.stderr[-2000:]}")
        C.log(f"[mesh_cards] init_distributed, NCCL, two cards: "
              f"{result['nccl']} ({time.perf_counter() - t0:.1f}s)")
    finally:
        shutil.rmtree(C.WORK, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_start
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    C.log(f"[mesh_cards] {result['seconds']:.0f}s in all")
    C.log(json.dumps({"ok": True, "device_count": result["device_count"]}))


if __name__ == "__main__":
    main()
