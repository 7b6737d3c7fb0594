"""Mapper CLI (nvBowtie equivalent): index + reads -> SAM.

Port of ``nvbio_tpu/tools/map_reads.py`` for single-end and paired-end
reads, with the reference's flags and defaults (Bowtie2 names:
-x/-U/-1/-2/-S, -L seed length, -i interval, -N seed mismatches,
--local, --mp/--rdg/--rfg/--ma/--np, --score-min, --minins/--maxins,
--fr/--rf/--ff, --no-mixed, --no-discordant, --dovetail, --no-contain,
--no-overlap; nvBowtie's -a/--all with --max-alns) plus an explicit
``--device``:

    python -m nvbio_tpu_torch.tools.map_reads -x ref.npz -U reads.fq \\
        -S out.sam --device cuda
    python -m nvbio_tpu_torch.tools.map_reads -x ref.npz -U reads.fq \\
        -S out.sam --device cuda --local -N 1
    python -m nvbio_tpu_torch.tools.map_reads -x ref.npz -U reads.fq \\
        -S out.sam --device cuda -a --max-alns 8
    python -m nvbio_tpu_torch.tools.map_reads -x ref.npz -1 r1.fq \\
        -2 r2.fq -S out.sam --device cuda

    python -m nvbio_tpu_torch.tools.map_reads -x ref.npz -U reads.fq \\
        -S out.sam --device cuda --phred64 --un un.fq.gz --al al.fq \\
        --rg-id rg1 --rg SM:s1 --stats s.json --html report.html
    python -m nvbio_tpu_torch.tools.map_reads -x hg38.manifest.json \\
        -U reads.fq -S out.sam --device cuda

-x names an unsharded .npz, or a sharded index (build_index --shard-bp)
by its prefix or its .manifest.json; every mode and option above maps
against either.  On a sharded index --mesh picks the schedule, as in the
reference: 'on' maps shard-per-device (MeshShardedMapper: shard k on
card k, or every shard on the CPU under --device cpu), 'auto' does so
where there are at least as many cards as shards (more than one), and
'off' (or auto with fewer cards) runs the shards one after another on
one device; the SAM is the same.  --batch must divide by the shard count
on the mesh.  On an unsharded index --mesh is ignored.  --fm2-mode is
taken and changes nothing: the port has no pair-BWT, and the
reference's modes give identical output.

As in the reference, -a applies to -U input only: with -1/-2 it is
taken and has no effect.  The input and output options are the
reference's too: --un/--al (FASTQ(.gz) of the reads that fail to align
or align; paired-end mates go into one file with /1 and /2 suffixes),
--rg-id/--rg (an @RG header line and an RG:Z tag on every record),
--phred64/--solexa-quals (input qualities; --un/--al write Phred+33),
--resume (skip the records already in a plain .sam and append),
--num-shards/--shard-id (map one record-aligned byte range of a plain
FASTQ; join the shards' SAM with sam_merge), --stats/--html (the
reference's MappingStats JSON and HTML report) and --xprof DIR (a
torch.profiler Chrome trace of the mapping loop).

--stats writes the reference's summary, whose reads_per_sec divides the
reads by the "total" timer (the mapping loop alone), plus the port's
keys: device, load_s (index load), map_s (from opening the output to
closing it) and reads_per_s (reads / map_s); with -1/-2 also pairs,
pairs_per_s (pairs / map_s), rescued and rescue_dropped.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import sys
import time

import numpy as np

from ..basic.alphabet import dna_to_char


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="map_reads", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-x", "--index", required=True,
                   help="index .npz, or a sharded index's prefix or "
                   ".manifest.json")
    p.add_argument("-U", help="unpaired reads (FASTQ/FASTA/SAM, .gz ok)")
    p.add_argument("-1", dest="m1", help="mate-1 FASTQ(.gz)")
    p.add_argument("-2", dest="m2", help="mate-2 FASTQ(.gz)")
    p.add_argument("-S", "--sam", required=True, help="output SAM (.gz ok), or BAM for a .bam path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never picked implicitly")
    p.add_argument("-L", "--seed-len", type=int, default=22)
    p.add_argument("-i", "--seed-interval", default="S,1,1.15",
                   help="seed interval: a constant or a Bowtie2 function "
                   "FN,A,B of read length (C, L, S, G; default S,1,1.15)")
    p.add_argument("--max-read-len", type=int, default=320,
                   help="pad/bucket reads to this many bp; raise for "
                   "long reads (the DP engine row-blocks patterns "
                   "beyond 512 bp automatically)")
    p.add_argument("--band", type=int, default=None,
                   help="extension band half-width (default 15; long "
                   "reads want more indel drift room, e.g. 63)")
    p.add_argument("--minins", type=int, default=0)
    p.add_argument("--maxins", type=int, default=500)
    orient = p.add_mutually_exclusive_group()
    orient.add_argument("--fr", dest="pe_orient", action="store_const",
                        const="fr", help="mates: upstream forward / "
                        "downstream reverse (default; bowtie2 --fr)")
    orient.add_argument("--rf", dest="pe_orient", action="store_const",
                        const="rf", help="mates: upstream reverse / "
                        "downstream forward (bowtie2 --rf)")
    orient.add_argument("--ff", dest="pe_orient", action="store_const",
                        const="ff", help="mates: both same strand, "
                        "mate 1 upstream (bowtie2 --ff)")
    p.set_defaults(pe_orient="fr")
    p.add_argument("--no-mixed", action="store_true",
                   help="suppress single-end fallback for pairs that "
                   "fail to align as pairs (bowtie2 --no-mixed)")
    p.add_argument("--no-discordant", action="store_true",
                   help="suppress discordant pair reports "
                   "(bowtie2 --no-discordant)")
    p.add_argument("--dovetail", action="store_true",
                   help="mates that extend past each other can still "
                   "be concordant (bowtie2 --dovetail)")
    p.add_argument("--no-contain", action="store_true",
                   help="a mate containing the other is not "
                   "concordant (bowtie2 --no-contain)")
    p.add_argument("--no-overlap", action="store_true",
                   help="overlapping mates are not concordant "
                   "(bowtie2 --no-overlap)")
    p.add_argument("-N", dest="seed_mm", type=int, default=0, choices=[0, 1],
                   help="mismatches allowed in seed (bowtie2 -N)")
    p.add_argument("--local", action="store_true",
                   help="local alignment: soft clips, match bonus "
                   "(bowtie2 --local)")
    p.add_argument("--ma", type=int, default=None,
                   help="match bonus (default: 2 in --local, 0 "
                   "end-to-end)")
    p.add_argument("--mp", default="6,2", metavar="MX,MN",
                   help="max,min mismatch penalty, scaled by base quality")
    p.add_argument("--np", dest="n_pen", type=int, default=1,
                   help="penalty for positions with N")
    p.add_argument("--rdg", default="5,3", metavar="O,E",
                   help="read gap open,extend (CIGAR D)")
    p.add_argument("--rfg", default="5,3", metavar="O,E",
                   help="reference gap open,extend (CIGAR I)")
    p.add_argument("--score-min", default=None, metavar="FN,A,B",
                   help="minimum score function of read length "
                   "(default L,-0.6,-0.6 end-to-end, G,20,8 --local)")
    p.add_argument("-a", "--all", dest="all_hits", action="store_true",
                   help="report all alignments above score-min, the "
                   "best as primary, the others FLAG 0x100 (-U only)")
    p.add_argument("--max-alns", type=int, default=8,
                   help="per-read alignment cap in --all mode")
    p.add_argument("--batch", type=int, default=4096,
                   help="reads per device batch")
    p.add_argument("--lut-k", type=int, default=None,
                   help="rebuild the seed-tail k-mer LUT at this depth "
                   "at load time (0 = none; default: the index's; on a "
                   "sharded index 0 keeps the stored one, as the "
                   "reference)")
    p.add_argument("--locate-frac", type=float, default=None,
                   help="cross-read SSA-locate budget as a fraction of "
                   "the selected hit slots (default 0.25)")
    p.add_argument("--extend-frac", type=float, default=None,
                   help="extension budget as a fraction of the "
                   "candidate slot matrix (default 0.25)")
    p.add_argument("--un", metavar="FQ",
                   help="write reads that fail to align to this "
                   "FASTQ(.gz) (bowtie2 --un)")
    p.add_argument("--al", metavar="FQ",
                   help="write reads that align at least once to this "
                   "FASTQ(.gz) (bowtie2 --al)")
    p.add_argument("--rg-id", metavar="ID",
                   help="read group ID: adds @RG SAM header + RG:Z "
                   "tag on every record (bowtie2 --rg-id)")
    p.add_argument("--rg", action="append", default=[],
                   metavar="FIELD:VALUE",
                   help="add FIELD:VALUE to the @RG line (repeatable; "
                   "needs --rg-id; bowtie2 --rg)")
    p.add_argument("--phred64", action="store_true",
                   help="input qualities are Phred+64")
    p.add_argument("--solexa-quals", action="store_true",
                   help="input qualities are Solexa+64 (converted to "
                   "Phred)")
    p.add_argument("--stats", metavar="JSON",
                   help="write the run's MappingStats JSON here, with "
                   "the port's device, load_s, map_s and reads_per_s")
    p.add_argument("--html", help="write HTML run report here")
    p.add_argument("--num-shards", type=int, default=1,
                   help="total input shards (multi-host: one per host)")
    p.add_argument("--shard-id", type=int, default=0,
                   help="this process's shard index")
    p.add_argument("--resume", action="store_true",
                   help="restart an interrupted run: skip reads already "
                   "present in the output SAM and append (plain .sam "
                   "only)")
    p.add_argument("--xprof", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the "
                   "mapping loop into DIR")
    p.add_argument("--mesh", default="auto", choices=["auto", "on", "off"],
                   help="sharded index: 'on' maps shard-per-device (one "
                   "card a shard; every shard on the CPU under --device "
                   "cpu), 'auto' does so with at least as many cards as "
                   "shards, 'off' maps the shards one after another on one "
                   "device (ignored on an unsharded index)")
    p.add_argument("--fm2-mode", default="auto",
                   choices=["auto", "off", "resident", "stream"],
                   help="taken for the reference's command lines; the port "
                   "has no 2-step FM-index and maps batch-major in every "
                   "mode (the reference's modes give identical output)")
    args = p.parse_args(argv)
    if args.resume and (args.sam.endswith(".gz")
                        or args.sam.endswith(".bam") or args.m1):
        p.error("--resume supports unpaired plain .sam output")
    if not args.U and not (args.m1 and args.m2):
        p.error("need -U or -1/-2")
    if args.rg and not args.rg_id:
        p.error("--rg needs --rg-id")
    if args.max_alns < 1:
        p.error("--max-alns wants a positive count")
    return p, args


def _pair(p, txt, flag):
    try:
        a, b = txt.split(",")
        return int(a), int(b)
    except ValueError:
        p.error(f"{flag} wants two comma-separated ints, got {txt!r}")


def _func(p, txt, flag):
    """Bowtie2 SimpleFunc literal FN,A,B."""
    try:
        fn, a, b = txt.split(",")
        fn = fn.strip().upper()
        if fn not in ("C", "L", "S", "G"):
            raise ValueError(fn)
        return fn, float(a), float(b)
    except ValueError:
        p.error(f"{flag} wants FN,A,B with FN in C/L/S/G, got {txt!r}")


def main(argv=None):
    p, args = _parse(argv)
    import os

    import torch

    from ..io.bam import BamWriter
    from ..io.fastq import FastqBatchReader
    from ..io.sam import SamWriter
    from ..io.sequence import ReadBatchIterator, open_read_iter
    from ..parallel.distributed import read_fastq_range, shard_fastq
    from ..utils.stats import MappingStats

    from ..alignment.types import GotohScheme
    from ..device import resolve_device
    from ..fmindex.build import build_kmer_lut
    from ..fmindex.sharded import load_sharded_index, read_manifest
    from ..io.index_file import load_index
    from ..models.mapper import Mapper, MapResult
    from ..models.mesh_sharded import (MeshPairedShardedMapper,
                                       MeshShardedMapper)
    from ..models.paired import PairedMapper
    from ..models.sharded_mapper import PairedShardedMapper, ShardedMapper
    from ..models.params import MapperParams, eval_simple_func
    from ..strings.string_set import pack_reads

    device = resolve_device(args.device)
    prefix = args.index[:-len(".manifest.json")] \
        if args.index.endswith(".manifest.json") else args.index
    sharded = os.path.exists(prefix + ".manifest.json")
    use_mesh = False
    if sharded:
        # the reference's choice: on, or auto with at least as many
        # devices as shards (one device on the CPU)
        n_shards = len(read_manifest(prefix)["shards"])
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        use_mesh = (args.mesh == "on"
                    or (args.mesh == "auto" and n_dev >= n_shards > 1))
        if use_mesh and args.batch % n_shards:
            p.error(f"--mesh needs --batch divisible by the "
                    f"{n_shards}-shard mesh")

    mp_mx, mp_mn = _pair(p, args.mp, "--mp")
    rdg_o, rdg_e = _pair(p, args.rdg, "--rdg")
    rfg_o, rfg_e = _pair(p, args.rfg, "--rfg")
    ma = args.ma if args.ma is not None else (2 if args.local else 0)
    scheme = GotohScheme(
        match=ma, mismatch_min=mp_mn,
        mismatch_max=mp_mx, n_penalty=args.n_pen, gap_open=rdg_o,
        gap_extend=rdg_e, ref_gap_open=rfg_o, ref_gap_extend=rfg_e)
    sm = args.score_min or ("G,20,8" if args.local else "L,-0.6,-0.6")
    sm_fn, sm_a, sm_b = _func(p, sm, "--score-min")
    # seed interval: a constant, or a function of read length that the
    # mapper re-evaluates per chunk; the first read's length seeds the
    # fallback interval
    ifn = None
    try:
        seed_interval = int(args.seed_interval)
    except ValueError:
        ifn = _func(p, args.seed_interval, "-i")
        L0 = 100
        for _, s0, _ in open_read_iter(args.U or args.m1):
            L0 = len(s0)
            break
        seed_interval = max(1, int(eval_simple_func(*ifn, L0) + 0.5))

    t0 = time.perf_counter()
    if sharded:
        # the mesh places each shard on its own device
        sidx, genome, meta = load_sharded_index(
            prefix, lut_k=args.lut_k, device="cpu" if use_mesh else device)
        genome = genome.astype(np.uint8)
        lut_k = meta["lut_k"]
    else:
        fm, ssa, genome, meta = load_index(args.index, device=device)
        lut, lut_k = meta.get("lut"), meta.get("lut_k", 0)
        if args.lut_k is not None and args.lut_k != lut_k:
            lut_k = args.lut_k
            lut = None
            if lut_k > 0:
                lo, hi = build_kmer_lut(genome.astype(np.uint8), k=lut_k)
                lut = (torch.from_numpy(lo).to(device),
                       torch.from_numpy(hi).to(device))
    params = MapperParams(
        seed_len=args.seed_len,
        seed_interval=seed_interval,
        **({"seed_interval_fn": ifn[0], "seed_interval_a": ifn[1],
            "seed_interval_b": ifn[2]} if ifn else {}),
        seed_mismatches=args.seed_mm,
        local=args.local,
        **({"band_w": args.band} if args.band is not None else {}),
        scheme=scheme,
        score_min_fn=sm_fn, score_min_a=sm_a, score_min_b=sm_b,
        batch_size=args.batch,
        sa_sample=meta["sa_sample"],
        lut_k=lut_k,
        max_read_len=args.max_read_len,
        minins=args.minins,
        maxins=args.maxins,
        pe_orient=args.pe_orient,
        pe_dovetail=args.dovetail,
        pe_no_contain=args.no_contain,
        pe_no_overlap=args.no_overlap,
        no_mixed=args.no_mixed,
        no_discordant=args.no_discordant,
        **({"locate_frac": args.locate_frac}
           if args.locate_frac is not None else {}),
        **({"extend_frac": args.extend_frac}
           if args.extend_frac is not None else {}),
    )
    contigs = {
        "names": meta["contig_names"],
        "starts": np.concatenate(
            [[0], np.cumsum(meta["contig_lens"][:-1])]).astype(np.int64),
        "lens": np.array(meta["contig_lens"], dtype=np.int64),
    }
    paired = not args.U
    if use_mesh:
        cls = MeshPairedShardedMapper if paired else MeshShardedMapper
        mapper = cls(sidx, genome, params=params, contigs=contigs,
                     devices=(None if device.type == "cuda"
                              else [device] * n_shards))
        print(f"[map_reads] mesh: {n_shards} shards over {n_shards} "
              "devices (shard-per-chip)", file=sys.stderr)
    elif sharded:
        cls = PairedShardedMapper if paired else ShardedMapper
        mapper = cls(sidx, genome, params=params, contigs=contigs)
    else:
        cls = PairedMapper if paired else Mapper
        mapper = cls(fm, ssa, genome, params=params, contigs=contigs, lut=lut)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0

    qual_enc = ("solexa64" if args.solexa_quals
                else "phred64" if args.phred64 else "phred33")
    stats = MappingStats()
    n_done = 0
    if args.resume and os.path.exists(args.sam):
        with open(args.sam) as f:
            n_done = sum(1 for ln in f if not ln.startswith("@"))
        print(f"[map_reads] resume: {n_done} records already written",
              file=sys.stderr)

    def batches(path):
        """Input batches, restricted to this process's shard of the
        input with --num-shards > 1."""
        if args.num_shards <= 1:
            yield from ReadBatchIterator(path, args.batch, qual_enc=qual_enc)
            return
        start, end = shard_fastq(path, args.num_shards)[args.shard_id]
        names, seqs, quals = read_fastq_range(path, start, end)
        for i in range(0, len(names), args.batch):
            sl = slice(i, i + args.batch)
            yield names[sl], seqs[sl], quals[sl]

    def packed():
        skip = n_done
        for names, seqs, quals in batches(args.U):
            if skip >= len(names):  # whole batch already mapped
                skip -= len(names)
                continue
            if skip:
                names, seqs, quals = names[skip:], seqs[skip:], quals[skip:]
                skip = 0
            reads, lens, qmat, _ = pack_reads(seqs, quals,
                                              max_len=args.max_read_len)
            yield names, reads, lens, qmat

    def packed_pe():
        it1 = FastqBatchReader(args.m1, args.batch, qual_enc=qual_enc)
        it2 = FastqBatchReader(args.m2, args.batch, qual_enc=qual_enc)
        for (n1, s1, q1), (_, s2, q2) in zip(it1, it2):
            r1, l1, qm1, _ = pack_reads(s1, q1, max_len=args.max_read_len)
            r2, l2, qm2, _ = pack_reads(s2, q2, max_len=args.max_read_len)
            yield n1, r1, l1, qm1, r2, l2, qm2

    rg_line = None
    if args.rg_id:
        rg_line = "@RG\tID:" + args.rg_id + "".join(
            "\t" + f for f in args.rg)
    n_pairs = 0
    t1 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        # BAM for a .bam path, as the reference chooses; SAM (.gz ok) else
        writer_cls = BamWriter if args.sam.endswith(".bam") else SamWriter
        writer = stack.enter_context(writer_cls(
            args.sam, meta["contig_names"], meta["contig_lens"],
            cmdline=" ".join(argv if argv is not None else sys.argv[1:]),
            rg_line=rg_line, **({"append": True} if n_done else {})))
        route = _FastqRoute(
            *(stack.enter_context(_open_fq(path)) if path else None
              for path in (args.un, args.al)))
        if args.xprof:
            prof = stack.enter_context(_profiler(device))

        def write(recs):
            for rec in recs:
                if args.rg_id:  # after every other tag, as bowtie2
                    rec.tags.append(("RG", "Z", args.rg_id))
                writer.write(rec)

        with stats.timer("total"):
            if paired:
                with stats.timer("compute"):
                    for (names, r1, l1, qm1, r2, l2, qm2, res1, res2,
                         info) in mapper.map_pairs_stream(packed_pe()):
                        n_pairs += len(info)
                        stats.observe(res1)
                        stats.observe(res2)
                        stats.proper_pairs += sum(i["proper"] for i in info)
                        stats.discordant += sum(i["discordant"]
                                                for i in info)
                        # mate 2 takes mate 1's names, as in the reference
                        route(names, r1, l1, qm1,
                              [r.aligned for r in res1], "/1")
                        route(names, r2, l2, qm2,
                              [r.aligned for r in res2], "/2")
                        with stats.timer("output"):
                            write(mapper.to_sam_records_pe(
                                names, r1, l1, qm1, r2, l2, qm2, res1, res2,
                                info))
            elif args.all_hits:
                for names, reads, lens, qmat in packed():
                    with stats.timer("compute"):
                        all_res = mapper.map_reads_all(
                            reads, lens, qmat, max_alns=args.max_alns)
                    stats.observe([a[0] if a else MapResult(aligned=False)
                                   for a in all_res])
                    route(names, reads, lens, qmat,
                          [bool(a and a[0].aligned) for a in all_res])
                    with stats.timer("output"):
                        write(mapper.to_sam_records_all(names, reads, lens,
                                                        qmat, all_res))
            else:
                with stats.timer("compute"):
                    for names, reads, lens, qmat, results in \
                            mapper.map_stream(packed()):
                        stats.observe(results)
                        route(names, reads, lens, qmat,
                              [r.aligned for r in results])
                        with stats.timer("output"):
                            write(mapper.to_sam_records(names, reads, lens,
                                                        qmat, results))
    t_map = time.perf_counter() - t1
    if args.xprof:
        os.makedirs(args.xprof, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.xprof,
                                              "map_reads.trace.json"))
    stats.locate_dropped = mapper.locate_dropped
    stats.escalated = mapper.escalated
    stats.overflowed = mapper.overflowed
    if stats.locate_dropped:
        print(f"[map_reads] locate budget overflow: "
              f"{stats.locate_dropped} candidate slots dropped "
              "(raise --locate-frac toward 1.0 to locate everything)",
              file=sys.stderr)
    if stats.escalated:
        print(f"[map_reads] effort escalation: {stats.overflowed} reads "
              f"overflowed round-1 budgets; {stats.escalated} re-maps "
              f"across {mapper.params.max_effort - 1} escalation "
              "round(s)", file=sys.stderr)
    report = stats.summary()
    stats.report(file=sys.stderr)
    report.update({
        "device": str(device),
        "load_s": t_load,
        "map_s": t_map,
        "reads_per_s": stats.reads / t_map if t_map > 0 else math.nan,
    })
    if paired:
        report.update({
            "pairs": n_pairs,
            "pairs_per_s": n_pairs / t_map if t_map > 0 else math.nan,
            "rescued": mapper.rescued,
            "rescue_dropped": mapper.rescue_dropped,
        })
    print(f"[map_reads] {stats.reads} reads ({stats.aligned} aligned"
          + (f"; {n_pairs} pairs, {stats.proper_pairs} proper"
             if paired else "")
          + f") on {device} in {t_map:.2f}s after {t_load:.2f}s index load",
          file=sys.stderr)
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(report, f, indent=2)
    if args.html:
        with open(args.html, "w") as f:
            f.write(stats.html(title=f"map_reads: {args.U or args.m1}"))
    return 0


def _open_fq(path):
    return gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")


class _FastqRoute:
    """--un / --al: each read to the FASTQ of its outcome (bowtie2
    --un/--al), its sequence from the packed codes and its quality as
    Phred+33 whatever the input's encoding.  A batch's symbols and
    qualities are converted in one pass and each file gets one write."""

    def __init__(self, un_f, al_f):
        self.un_f, self.al_f = un_f, al_f

    def __call__(self, names, reads, lens, qmat, aligned, suffix=""):
        if self.un_f is None and self.al_f is None:
            return
        reads, qmat = np.asarray(reads), np.asarray(qmat)
        lens = np.minimum(np.asarray(lens, np.int64), reads.shape[1])
        valid = np.arange(reads.shape[1]) < lens[:, None]
        seq = dna_to_char(reads[valid].astype(np.uint8)).tobytes().decode()
        qual = (qmat[valid].astype(np.uint8) + 33).clip(33, 126).astype(
            np.uint8).tobytes().decode()
        ends = np.cumsum(lens).tolist()
        out = {False: [], True: []}
        for i, (nm, a, b) in enumerate(zip(names, [0] + ends, ends)):
            out[bool(aligned[i])].append(
                f"@{nm}{suffix}\n{seq[a:b]}\n+\n{qual[a:b]}\n")
        for f, recs in ((self.un_f, out[False]), (self.al_f, out[True])):
            if f is not None and recs:
                f.write("".join(recs))


def _profiler(device):
    """torch.profiler over the mapping loop: CPU activity, and CUDA
    activity on a CUDA device."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


if __name__ == "__main__":
    sys.exit(main())
