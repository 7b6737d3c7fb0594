"""Export our .npz index to BWA-layout files (.pac/.bwt/.sa/.ann/.amb,
optionally .rpac/.rbwt/.rsa for the reversed text).

Port of ``nvbio_tpu/tools/bwa_export.py`` (host work):

    python -m nvbio_tpu_torch.tools.bwa_export g.npz g --reverse

The BWT comes straight from the stored FM-index words (``load_index``);
the sampled SA is re-derived with the native SA-IS sorter (row-sampled
at --sa-intv, BWA's discipline, which differs from our value-marked
SSA).  The reversed text's FM arrays come from ``fmindex.build.
build_fm_arrays``.  The files are byte-equal to the reference tool's.

Ref parity: SURVEY.md Appendix A — the converter that lets the
reference (or any BWA-compatible tool) cross-validate our index.
"""

from __future__ import annotations

import argparse
import sys


def export(index_path: str, prefix: str, sa_intv: int = 32,
           reverse: bool = False) -> None:
    import numpy as np
    from ..fmindex.build import build_fm_arrays
    from ..io.bwa_files import (write_bwt, write_sa, write_ann,
                                write_amb, bwt_from_index)
    from ..io.index_file import index_from_numpy, load_index, write_pac
    from ..sufsort.sa import suffix_array

    fm, ssa, genome, meta = load_index(index_path)
    syms = np.asarray(genome).astype(np.uint8) & 3
    n = len(syms)

    write_pac(prefix + ".pac", syms)
    bwt = bwt_from_index(fm)
    primary = int(np.asarray(fm.primary))
    write_bwt(prefix + ".bwt", bwt, primary, np.asarray(fm.C))

    # row-sampled SA (BWA discipline): SA[k*intv] for k = 1..n_sa-1.
    # sa[] from the sorter covers rows 1..n (row 0 = sentinel).
    sa = suffix_array(syms)
    sa_full = np.empty(n + 1, np.int64)
    sa_full[0] = n
    sa_full[1:] = sa
    n_sa = (n + sa_intv) // sa_intv
    rows = np.arange(1, n_sa, dtype=np.int64) * sa_intv
    counts = np.bincount(bwt, minlength=4)[:4]
    L2 = np.cumsum(counts)
    write_sa(prefix + ".sa", sa_full[rows], sa_intv, primary, L2, n)

    names = meta.get("contig_names", ["seq"])
    lens = meta.get("contig_lens", [n])
    amb = meta.get("amb", [])
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    n_ambs = [
        sum(1 for a, _l in amb if starts[i] <= a < starts[i] + lens[i])
        for i in range(len(names))
    ]
    write_ann(prefix + ".ann", n, names, lens, n_ambs)
    write_amb(prefix + ".amb", n, len(names),
              [(a, l, "N") for a, l in amb])

    if reverse:
        rsyms = syms[::-1].copy()
        rsa = suffix_array(rsyms)
        rfm_fields, rssa_fields = build_fm_arrays(rsyms, sa_sample=sa_intv,
                                                  sa=rsa)
        rfm = index_from_numpy(rfm_fields, rssa_fields, rsyms)[0]
        rbwt = bwt_from_index(rfm)
        write_pac(prefix + ".rpac", rsyms)
        write_bwt(prefix + ".rbwt", rbwt, int(rfm.primary),
                  np.asarray(rfm.C))
        rsa_full = np.empty(n + 1, np.int64)
        rsa_full[0] = n
        rsa_full[1:] = rsa
        rrows = np.arange(1, n_sa, dtype=np.int64) * sa_intv
        rL2 = np.cumsum(np.bincount(rbwt, minlength=4)[:4])
        write_sa(prefix + ".rsa", rsa_full[rrows], sa_intv,
                 int(rfm.primary), rL2, n)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="bwa_export", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("index", help="our .npz index")
    p.add_argument("prefix", help="output prefix for .pac/.bwt/...")
    p.add_argument("--sa-intv", type=int, default=32,
                   help="BWA .sa row-sampling interval")
    p.add_argument("--reverse", action="store_true",
                   help="also write .rpac/.rbwt/.rsa (reversed text)")
    args = p.parse_args(argv)
    export(args.index, args.prefix, sa_intv=args.sa_intv,
           reverse=args.reverse)
    print(f"[bwa_export] wrote {args.prefix}.{{pac,bwt,sa,ann,amb"
          f"{',rpac,rbwt,rsa' if args.reverse else ''}}}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
