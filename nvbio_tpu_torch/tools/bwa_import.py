"""Import BWA-layout index files (.pac/.ann/.amb, verifying .bwt when
present) into our .npz container.

Port of ``nvbio_tpu/tools/bwa_import.py`` (host work):

    python -m nvbio_tpu_torch.tools.bwa_import g g.npz

The genome comes from .pac, contig names/lengths from .ann, ambiguity
runs from .amb.  The FM-index is rebuilt from the text (native SA-IS,
``fmindex.build.build_fm_arrays``, ``build_kmer_lut``); if a .bwt file
is present its primary and BWT string are checked against the rebuilt
index, so an externally-produced index is cross-validated on the way
in.  The .npz arrays equal the reference tool's.

Ref parity: SURVEY.md Appendix A.
"""

from __future__ import annotations

import argparse
import sys


def import_index(prefix: str, out_path: str, sa_sample: int = 4,
                 lut_k: int = 11, bi_sample: bool = True) -> dict:
    import os

    import numpy as np
    from ..fmindex.build import build_fm_arrays, build_kmer_lut
    from ..io.bwa_files import read_ann, read_amb, read_bwt, bwt_from_index
    from ..io.index_file import index_from_numpy, read_pac, save_index
    from ..sufsort.sa import suffix_array

    syms = read_pac(prefix + ".pac")
    ann = read_ann(prefix + ".ann")
    amb = read_amb(prefix + ".amb") if os.path.exists(prefix + ".amb") \
        else {"holes": []}

    sa = suffix_array(syms)
    fm_fields, ssa_fields = build_fm_arrays(syms, sa_sample=sa_sample, sa=sa,
                                            bi_sample=bi_sample)

    report = {"bwt_checked": False}
    if os.path.exists(prefix + ".bwt"):
        ext_bwt, ext_primary, ext_L2 = read_bwt(prefix + ".bwt")
        fm = index_from_numpy(fm_fields, ssa_fields, syms)[0]
        ours = bwt_from_index(fm)
        if ext_primary != fm.primary:
            raise ValueError(
                f"{prefix}.bwt primary {ext_primary} != rebuilt "
                f"{fm.primary}")
        if not np.array_equal(ext_bwt, ours):
            bad = int(np.flatnonzero(ext_bwt != ours)[0])
            raise ValueError(
                f"{prefix}.bwt differs from rebuilt BWT at row {bad}")
        report["bwt_checked"] = True

    lut = build_kmer_lut(syms, k=lut_k) if lut_k > 0 else None
    save_index(out_path, fm_fields, ssa_fields, syms.astype(np.int8),
               ann["names"], ann["lens"], sa_sample,
               sa_bi=int(bi_sample), lut=lut, lut_k=lut_k,
               amb=[(off, ln) for off, ln, _ch in amb["holes"]])
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="bwa_import", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("prefix", help="BWA index prefix (.pac/.ann/...)")
    p.add_argument("output", help="output .npz index")
    p.add_argument("--sa-sample", type=int, default=4)
    p.add_argument("--lut-k", type=int, default=11)
    p.add_argument("--sa-mono", action="store_true")
    args = p.parse_args(argv)
    rep = import_index(args.prefix, args.output,
                       sa_sample=args.sa_sample, lut_k=args.lut_k,
                       bi_sample=not args.sa_mono)
    print(f"[bwa_import] wrote {args.output} "
          f"(bwt cross-check: "
          f"{'PASSED' if rep['bwt_checked'] else 'no .bwt present'})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
