"""Read error-correction CLI (nvLighter equivalent).

Port of ``nvbio_tpu/tools/correct_reads.py``: two passes over the FASTQ
(k-mer counting into a count-min sketch, then greedy correction) on
``--device``, corrected FASTQ out:

    python -m nvbio_tpu_torch.tools.correct_reads r.fq fixed.fq
    python -m nvbio_tpu_torch.tools.correct_reads r.fq fixed.fq.gz \\
        -k 15 --log2-slots 24 --rounds 2 --device cpu

The reads are parsed once (the native parser, ``io.fastq.
read_fastq_packed``, which packs as the reference's batch reader and
``pack_reads`` do) and cut into ``--batch`` reads for each pass.  Output
and the stderr line are the reference's.

Ref parity: nvLighter/nvLighter.cu main.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="correct_reads", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("fastq", help="input FASTQ(.gz)")
    p.add_argument("output", help="corrected FASTQ(.gz)")
    p.add_argument("-k", type=int, default=15, help="k-mer size (<= 15)")
    p.add_argument("--log2-slots", type=int, default=24,
                   help="count-min sketch size (2^n slots)")
    p.add_argument("--min-count", type=int, default=3)
    p.add_argument("--rounds", type=int, default=1,
                   help="correction sweeps (>1 fixes multi-error "
                        "k-windows, ref: Lighter's greedy loop)")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--max-read-len", type=int, default=320)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never picked implicitly")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..io.fastq import read_fastq_packed, write_fastq
    from ..models.corrector import Corrector

    device = resolve_device(args.device)
    names, reads, lens, qmat = read_fastq_packed(args.fastq,
                                                 args.max_read_len)
    spans = [slice(s, s + args.batch)
             for s in range(0, len(names), args.batch)]
    # pass 1: count k-mers
    corr = Corrector.build((reads[b] for b in spans), (lens[b] for b in spans),
                           k=args.k, log2_slots=args.log2_slots,
                           device=device)
    # pass 2: correct and write
    out = []
    fixed = 0
    for b in spans:
        creads, ncorr = corr.correct(reads[b], lens[b],
                                     min_count=args.min_count,
                                     rounds=args.rounds)
        fixed += int(ncorr.sum())
        for i, ln in enumerate(lens[b]):
            out.append((names[b.start + i], creads[i, :ln].astype(np.uint8),
                        qmat[b.start + i, :ln]))
    write_fastq(args.output, out)
    print(f"[correct_reads] {len(names)} reads, {fixed} corrections",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
