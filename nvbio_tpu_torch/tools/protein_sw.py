"""Protein Smith-Waterman CLI (examples/proteinsw equivalent).

Port of ``nvbio_tpu/tools/protein_sw.py``: scores every query protein
against every target protein with local affine-gap SW over BLOSUM62,
printing a TSV of best scores:

    python -m nvbio_tpu_torch.tools.protein_sw q.fa t.fa -o scores.tsv
    python -m nvbio_tpu_torch.tools.protein_sw q.fa t.fa --device cpu

The all-pairs batch is laid out on ``--device`` and scored by
``alignment.extra.full_score_batch`` at band_w = max(Lq, Lt): K5's
matrix mode on CUDA, the plain twin on the CPU.  Output and the stderr
line are the reference's.

Ref parity: examples/proteinsw/proteinsw.cu — substitution-matrix
local alignment demo on the batched DP engine.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="protein_sw", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("queries", help="query protein FASTA")
    p.add_argument("targets", help="target protein FASTA")
    p.add_argument("-o", "--out", default="-", help="output TSV (- = stdout)")
    p.add_argument("--gap-open", type=int, default=10)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never picked implicitly")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..alignment.blosum import MatrixScheme
    from ..alignment.extra import full_score_batch
    from ..alignment.types import AlignmentType
    from ..basic.alphabet import PROTEIN_X, encode_protein
    from ..device import resolve_device
    from ..io.fasta import read_fasta_text

    device = resolve_device(args.device)
    scheme = MatrixScheme(gap_open=args.gap_open,
                          gap_extend=args.gap_extend)
    qrecs = [(n, encode_protein(s)) for n, s in read_fasta_text(args.queries)]
    trecs = [(n, encode_protein(s)) for n, s in read_fasta_text(args.targets)]
    if not qrecs or not trecs:
        print("no sequences", file=sys.stderr)
        return 1

    def pack(recs):
        width = max(len(s) for _, s in recs)
        seqs = np.full((len(recs), width), PROTEIN_X, np.int8)
        lens = np.zeros(len(recs), np.int32)
        for i, (_, s) in enumerate(recs):
            seqs[i, : len(s)] = s
            lens[i] = len(s)
        return (torch.from_numpy(seqs).to(device),
                torch.from_numpy(lens).to(device))

    pats, plens = pack(qrecs)
    texts, tlens = pack(trecs)
    Q, T = len(qrecs), len(trecs)
    # all-pairs batch: query i against target j at row i * T + j
    res = full_score_batch(
        pats.repeat_interleave(T, dim=0), plens.repeat_interleave(T),
        texts.repeat(Q, 1), tlens.repeat(Q),
        scheme=scheme, atype=AlignmentType.LOCAL)
    scores = res["score"].reshape(Q, T).cpu().numpy()

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    print("query\ttarget\tscore", file=out)
    for i, (qn, _) in enumerate(qrecs):
        for j, (tn, _) in enumerate(trecs):
            print(f"{qn}\t{tn}\t{scores[i, j]}", file=out)
    if out is not sys.stdout:
        out.close()
    print(f"[protein_sw] {Q}x{T} alignments", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
