"""Read extractor CLI (nvExtractReads equivalent).

Ref parity: nvExtractReads/nvExtractReads.cpp — convert any supported
read file to a raw packed batch (benchmark feed): a .npz with the
padded symbol matrix, lengths, and qualities.

Port of ``nvbio_tpu/tools/extract_reads.py`` on the port's
``io/fastq.read_fastq`` and ``strings/string_set.pack_reads``:

    python -m nvbio_tpu_torch.tools.extract_reads reads.fq out.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="extract_reads", description=__doc__)
    p.add_argument("fastq", help="input FASTQ(.gz)")
    p.add_argument("output", help="output .npz")
    p.add_argument("--max-read-len", type=int, default=320)
    args = p.parse_args(argv)

    from ..io.fastq import read_fastq
    from ..strings.string_set import pack_reads

    names, seqs, quals = read_fastq(args.fastq)
    reads, lens, qmat, st = pack_reads(seqs, quals,
                                       max_len=args.max_read_len)
    np.savez(args.output, reads=reads, lens=lens, quals=qmat,
             names=np.array(names))
    print(f"[extract_reads] {len(names)} reads -> {args.output} "
          f"(truncated: {st['truncated']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
