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

As in the reference, -a applies to -U input only: with -1/-2 it is
taken and has no effect.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="map_reads", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-x", "--index", required=True, help="index .npz")
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
                   "at load time (0 = none; default: the index's)")
    p.add_argument("--locate-frac", type=float, default=None,
                   help="cross-read SSA-locate budget as a fraction of "
                   "the selected hit slots (default 0.25)")
    p.add_argument("--extend-frac", type=float, default=None,
                   help="extension budget as a fraction of the "
                   "candidate slot matrix (default 0.25)")
    p.add_argument("--stats", metavar="JSON",
                   help="write run counters and timings here")
    # reference flags outside this slice of the port
    p.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    p.add_argument("--xprof", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    unported = [
        (args.mesh, "--mesh"),
        (args.xprof, "--xprof"),
    ]
    for used, flag in unported:
        if used:
            p.error(f"{flag} is not ported to nvbio_tpu_torch yet; use "
                    "nvbio_tpu.tools.map_reads")
    if not args.U and not (args.m1 and args.m2):
        p.error("need -U or -1/-2")
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

    import numpy as np
    import torch

    from ..io.bam import BamWriter
    from ..io.fastq import FastqBatchReader
    from ..io.sam import SamWriter
    from ..io.sequence import ReadBatchIterator, open_read_iter

    from ..alignment.types import GotohScheme
    from ..device import resolve_device
    from ..fmindex.build import build_kmer_lut
    from ..io.index_file import load_index
    from ..models.mapper import Mapper
    from ..models.paired import PairedMapper
    from ..models.params import MapperParams, eval_simple_func
    from ..strings.string_set import pack_reads

    device = resolve_device(args.device)
    prefix = args.index[:-len(".manifest.json")] \
        if args.index.endswith(".manifest.json") else args.index
    if os.path.exists(prefix + ".manifest.json"):
        p.error("sharded indexes are not ported to nvbio_tpu_torch yet")

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
    cls = PairedMapper if paired else Mapper
    mapper = cls(fm, ssa, genome, params=params, contigs=contigs, lut=lut)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0

    def packed():
        for names, seqs, quals in ReadBatchIterator(args.U, args.batch):
            reads, lens, qmat, _ = pack_reads(seqs, quals,
                                              max_len=args.max_read_len)
            yield names, reads, lens, qmat

    def packed_pe():
        it1 = FastqBatchReader(args.m1, args.batch)
        it2 = FastqBatchReader(args.m2, args.batch)
        for (n1, s1, q1), (_, s2, q2) in zip(it1, it2):
            r1, l1, qm1, _ = pack_reads(s1, q1, max_len=args.max_read_len)
            r2, l2, qm2, _ = pack_reads(s2, q2, max_len=args.max_read_len)
            yield n1, r1, l1, qm1, r2, l2, qm2

    n_reads = n_aligned = n_pairs = n_proper = n_disc = 0
    t1 = time.perf_counter()
    # BAM for a .bam path, as the reference chooses; SAM (.gz ok) else
    writer_cls = BamWriter if args.sam.endswith(".bam") else SamWriter
    with writer_cls(args.sam, meta["contig_names"], meta["contig_lens"],
                    cmdline=" ".join(argv if argv is not None
                                     else sys.argv[1:])) as writer:
        if paired:
            for (names, r1, l1, qm1, r2, l2, qm2, res1, res2,
                 info) in mapper.map_pairs_stream(packed_pe()):
                n_pairs += len(info)
                n_reads += len(res1) + len(res2)
                n_aligned += sum(r.aligned for r in res1 + res2)
                n_proper += sum(i["proper"] for i in info)
                n_disc += sum(i["discordant"] for i in info)
                for rec in mapper.to_sam_records_pe(
                        names, r1, l1, qm1, r2, l2, qm2, res1, res2, info):
                    writer.write(rec)
        elif args.all_hits:
            for names, reads, lens, qmat in packed():
                all_res = mapper.map_reads_all(reads, lens, qmat,
                                               max_alns=args.max_alns)
                n_reads += len(all_res)
                n_aligned += sum(bool(a) for a in all_res)
                for rec in mapper.to_sam_records_all(names, reads, lens,
                                                     qmat, all_res):
                    writer.write(rec)
        else:
            for names, reads, lens, qmat, results in mapper.map_stream(
                    packed()):
                n_reads += len(results)
                n_aligned += sum(r.aligned for r in results)
                for rec in mapper.to_sam_records(names, reads, lens, qmat,
                                                 results):
                    writer.write(rec)
    t_map = time.perf_counter() - t1
    stats = {
        "device": str(device),
        "reads": n_reads,
        "aligned": n_aligned,
        "load_s": t_load,
        "map_s": t_map,
        "reads_per_s": n_reads / t_map if t_map > 0 else math.nan,
        "locate_dropped": mapper.locate_dropped,
        "overflowed": mapper.overflowed,
        "escalated": mapper.escalated,
    }
    if paired:
        stats.update({
            "pairs": n_pairs,
            "pairs_per_s": n_pairs / t_map if t_map > 0 else math.nan,
            "proper_pairs": n_proper,
            "discordant": n_disc,
            "rescued": mapper.rescued,
            "rescue_dropped": mapper.rescue_dropped,
        })
    print(f"[map_reads] {n_reads} reads ({n_aligned} aligned"
          + (f"; {n_pairs} pairs, {n_proper} proper" if paired else "")
          + f") on {device} in {t_map:.2f}s after {t_load:.2f}s index load",
          file=sys.stderr)
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
