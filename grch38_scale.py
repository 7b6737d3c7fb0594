#!/usr/bin/env python3
"""A GRCh38-scale sharded run of the PyTorch + CUDA port on one GPU.

    python3 grch38_scale.py            # the whole run, about half an hour

A seeded random genome with the lengths of GRCh38's 24 primary
chromosomes as separate contigs (3 088 269 832 bp, past the int32 of one
index) goes through the port's CLIs as a user would run them:

1. the genome as FASTA, then ``build_index --shard-bp 1600000000 --procs
   2`` in a subprocess (2 shards, the layout of the JAX package's hg-scale
   run): wall seconds, the stage lines the shard workers print, and the
   peak resident set of the largest process (``ru_maxrss`` of the
   children);
2. 100 000 simulated 100 bp reads drawn from the whole genome (2 %
   substitutions, 0.5 % indels); the kernels built from ops/csrc first
   (so that no build falls inside the timed run), then ``map_reads
   --device cuda -x <prefix>.manifest.json --mesh off --batch 4096
   --stats``: reads/s, index load seconds and the peak device bytes;
   before it, the device bytes of the index loaded and its ShardedMapper
   made (allocated across the two, as chip_smoke's device_bytes counts
   them) and a per-stage breakdown of that mapper's batches
   (chip_smoke.sharded_stage_breakdown);
3. the aligned share and the share within 8 bp of the origin on the
   origin's strand (gates 0.95 and 0.90), counted in per-contig
   coordinates, and the same for the reads whose origin lies past global
   position 2^31 (chr12 onwards), each of which must carry its origin's
   contig and per-contig POS.

Every line is printed with the time since the start, so an output cut by
a time limit says which step it reached.  The card's name and power limit
lead the output; the numbers also go to chiprun_out/grch38/result.json.
Bulk files go to .grch38_work/ (removed at the end).
"""

from __future__ import annotations

import json
import os
import resource
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".grch38_work")
OUT = os.path.join(ROOT, "chiprun_out", "grch38")
#: GRCh38's primary chromosomes and their lengths
CHROMS = (
    ("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
    ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
    ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
    ("chr10", 133_797_422), ("chr11", 135_086_622), ("chr12", 133_275_309),
    ("chr13", 114_364_328), ("chr14", 107_043_718), ("chr15", 101_991_189),
    ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
    ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
    ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415))
TOTAL_BP = 3_088_269_832
SHARD_BP, PROCS = 1_600_000_000, 2
N_READS, SEED = 100_000, 38
DEV = "cuda"
T0 = time.perf_counter()


def log(*args):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *args, flush=True)


def fail(msg):
    raise SystemExit(f"grch38_scale FAILED: {msg}")


def make_inputs(np):
    """The FASTA (one contig a chromosome, each from its own seed) and the
    reads; returns (contig starts, simulated reads)."""
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads

    lens = np.array([n for _, n in CHROMS], np.int64)
    if int(lens.sum()) != TOTAL_BP:
        fail(f"the chromosome lengths sum to {lens.sum()}")
    genome = np.empty(TOTAL_BP, np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for c, ((name, n), s) in enumerate(zip(CHROMS, starts)):
        genome[s:s + n] = random_genome(n, seed=SEED + c)
    write_fasta(f"{WORK}/g.fa", ((name, genome[s:s + n])
                                 for (name, n), s in zip(CHROMS, starts)),
                width=1 << 20)
    log(f"genome {TOTAL_BP} bp in {len(CHROMS)} contigs written as FASTA")
    sim = simulate_reads(genome, N_READS, 100, error_rate=0.02,
                         indel_rate=0.005, seed=SEED + 100)
    write_fastq(f"{WORK}/r.fq", [
        (f"r{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(N_READS)])
    log(f"{N_READS} reads of 100 bp simulated and written")
    return starts, lens, sim


def build():
    """build_index --shard-bp as a subprocess; (seconds, peak RSS bytes of
    the largest child process)."""
    t0 = time.perf_counter()
    tail = []
    with subprocess.Popen(
            [sys.executable, "-m", "nvbio_tpu_torch.tools.build_index",
             f"{WORK}/g.fa", f"{WORK}/g", "--shard-bp", str(SHARD_BP),
             "--procs", str(PROCS)], cwd=ROOT, stderr=subprocess.PIPE,
            text=True) as proc:
        for ln in proc.stderr:  # the stage lines as the build goes
            tail = (tail + [ln])[-40:]
            if ln.startswith("[build_index]"):
                log(ln.rstrip())
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"build_index exited with {proc.returncode}: {''.join(tail)}")
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
    return secs, rss


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    if os.path.exists(WORK):
        shutil.rmtree(WORK)
    os.makedirs(WORK)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    from nvbio_tpu_torch.fmindex.sharded import load_sharded_index
    from nvbio_tpu_torch.models.params import MapperParams
    from nvbio_tpu_torch.models.sharded_mapper import ShardedMapper
    from nvbio_tpu_torch.ops import _build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = card()
    log(smi)
    result = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    try:
        starts, lens, sim = make_inputs(np)
        result["build_s"], result["build_peak_rss"] = build()
        man = json.load(open(f"{WORK}/g.manifest.json"))
        result["shards"] = [(e["start"], e["length"]) for e in man["shards"]]
        log(f"build_index --shard-bp {SHARD_BP} --procs {PROCS}: "
            f"{result['build_s']:.1f}s, {len(man['shards'])} shards "
            f"{result['shards']}, peak RSS of the largest process "
            f"{result['build_peak_rss'] / 2**30:.2f} GiB")

        t0 = time.perf_counter()
        _build.library()
        log(f"kernels built in {time.perf_counter() - t0:.1f}s")
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        sidx, genome, _ = load_sharded_index(f"{WORK}/g", device=DEV)
        m = ShardedMapper(sidx, genome, params=MapperParams(
            seed_interval_fn="S", seed_interval_a=1.0, seed_interval_b=1.15,
            batch_size=4096, sa_sample=man["sa_sample"],
            lut_k=man["lut_k"]))
        torch.cuda.synchronize()
        result["mapper_bytes"] = torch.cuda.memory_allocated() - m0
        log(f"the loaded index and its ShardedMapper hold "
            f"{result['mapper_bytes'] / 2**30:.2f} GiB on the card")
        result["stages_ms"] = chip_smoke.sharded_stage_breakdown(
            torch, np, m, f"{WORK}/r.fq")
        log("one 4096-read batch, ms per stage (synchronised, median of "
            "3): " + ", ".join(f"{k} {v:.1f}"
                               for k, v in result["stages_ms"].items()))
        del m, sidx, genome
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        mapr(["-x", f"{WORK}/g.manifest.json", "-U", f"{WORK}/r.fq",
              "-S", f"{WORK}/out.sam", "--device", DEV, "--mesh", "off",
              "--batch", "4096", "--stats", f"{WORK}/stats.json"])
        torch.cuda.synchronize()
        stats = json.load(open(f"{WORK}/stats.json"))
        result.update(stats=stats,
                      peak_bytes=torch.cuda.max_memory_allocated())
        log(f"map_reads -x g.manifest.json --device {DEV} --mesh off "
            f"--batch 4096: {N_READS} reads in {stats['map_s']:.2f}s = "
            f"{stats['reads_per_s']:.0f} reads/s after {stats['load_s']:.1f}s"
            f" index load; peak {result['peak_bytes'] / 2**30:.2f} GiB on "
            f"the card")

        names = [n for n, _ in CHROMS]
        aligned = correct = high = high_ok = 0
        with open(f"{WORK}/out.sam") as f:
            recs = [ln for ln in f if not ln.startswith("@")]
        if len(recs) != N_READS:
            fail(f"{len(recs)} SAM records for {N_READS} reads")
        for i, ln in enumerate(recs):
            fld = ln.split("\t", 4)
            g0 = int(sim["true_pos"][i])
            c = int(np.searchsorted(starts, g0, side="right")) - 1
            ok = False
            flag = int(fld[1])
            if not flag & 4:
                aligned += 1
                ok = (fld[2] == names[c]
                      and int(bool(flag & 16)) == int(sim["true_strand"][i])
                      and abs(int(fld[3]) - 1 - (g0 - int(starts[c]))) <= 8)
                correct += ok
            if g0 >= 2**31:
                high += 1
                high_ok += ok
        result.update(aligned=aligned / N_READS,
                      correct=correct / max(aligned, 1),
                      past_2_31=high, past_2_31_correct=high_ok)
        log(f"aligned {aligned / N_READS:.4f} (gate 0.95); within 8 bp of "
            f"the origin on its strand and contig {correct / aligned:.4f} of "
            f"aligned (gate 0.90); reads from past global 2^31: {high}, "
            f"{high_ok} at their contig and per-contig POS")
        if aligned / N_READS < 0.95 or correct / aligned < 0.90:
            fail("accuracy gates missed")
        if high < 1000 or high_ok < 0.90 * high:
            fail(f"reads past 2^31: {high_ok} of {high} placed")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "result.json"), "w") as f:
            json.dump(result, f, indent=1, default=int)
    log(smi)
    log(json.dumps({k: v for k, v in result.items() if k != "stats"},
                   default=int))


if __name__ == "__main__":
    main()
