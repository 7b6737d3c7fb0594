"""Index builder CLI (nvBWT + nvSSA equivalent), host only.

Port of ``nvbio_tpu/tools/build_index.py``: FASTA -> concatenation +
seeded N substitution -> native SA-IS -> BWT, blocked occ tables,
sampled SA, k-mer LUT -> one ``.npz`` in the reference's format (it
loads in both packages), or, with ``--shard-bp``, a sharded index for
references past one int32 index (``<prefix>.manifest.json``, one
``.npz`` per shard and ``<prefix>.genome.npy``, the reference's files):

    python -m nvbio_tpu_torch.tools.build_index ref.fa ref.npz
    python -m nvbio_tpu_torch.tools.build_index hg38.fa hg38 \\
        --shard-bp 1600000000 --procs 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="build_index", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("fasta", help="reference FASTA (.fa/.fa.gz)")
    p.add_argument("output", help="output index (.npz)")
    p.add_argument("--sa-sample", type=int, default=4,
                   help="SA sampling rate K: locate walks < K LF steps")
    p.add_argument("--sa-mono", action="store_true",
                   help="mark only SA %% K == 0 rows (default also marks "
                   "SA %% K == 1, the reference's default layout)")
    p.add_argument("--n-seed", type=int, default=7,
                   help="RNG seed for ambiguous-base substitution")
    p.add_argument("--pac", help="also write a BWA-layout .pac here")
    p.add_argument("--lut-k", type=int, default=11,
                   help="seed-tail k-mer LUT width (0 = none)")
    p.add_argument("--algorithm", choices=["auto", "sais", "pd", "device"],
                   default="auto",
                   help="suffix sort: auto and sais both run native SA-IS")
    p.add_argument("--shard-bp", type=int, default=0,
                   help="build a SHARDED index with this many bp per "
                   "shard (for >2 Gbp references; writes "
                   "<output>.manifest.json + per-shard files)")
    p.add_argument("--shard-overlap", type=int, default=1024)
    p.add_argument("--procs", type=int, default=0,
                   help="sharded builds: worker processes (0 = one per "
                   "core up to the shard count; shards build "
                   "independently)")
    p.add_argument("--device-occ", action="store_true",
                   help="device occ tables are not ported yet")
    p.add_argument("--accelerator", action="store_true",
                   help="device index construction is not ported yet")
    args = p.parse_args(argv)
    if args.algorithm in ("pd", "device"):
        p.error(f"--algorithm {args.algorithm} is not ported: use auto/sais")
    if args.device_occ or args.accelerator:
        p.error("--device-occ/--accelerator: the port builds on the host")

    from ..io.fasta import read_fasta
    from ..io.genome import prepare_genome

    from ..fmindex.build import build_fm_arrays, build_kmer_lut, suffix_array
    from ..io.index_file import save_index, write_pac

    t0 = time.time()
    records = read_fasta(args.fasta)
    g = prepare_genome(records, n_sub_seed=args.n_seed)
    symbols = g["symbols"]
    print(f"[build_index] {len(records)} contigs, {len(symbols)} bp, "
          f"{len(g['amb'])} ambiguity runs", file=sys.stderr)
    if args.shard_bp > 0:
        from ..fmindex.sharded import build_sharded_index, save_sharded_index

        prefix = (args.output[:-4] if args.output.endswith(".npz")
                  else args.output)
        # mono SSA marks: the sharded mappers locate with single LF steps
        n_procs = args.procs or min(os.cpu_count() or 1,
                                    1 + len(symbols) // args.shard_bp)
        sidx = build_sharded_index(
            symbols, shard_bp=args.shard_bp, overlap=args.shard_overlap,
            sa_sample=args.sa_sample, lut_k=args.lut_k, bi_sample=False,
            n_procs=n_procs)
        save_sharded_index(prefix, sidx, symbols.astype("int8"), g["names"],
                           g["lens"])
        print(f"[build_index] wrote {len(sidx.shards)}-shard index "
              f"{prefix}.manifest.json in {time.time() - t0:.1f}s",
              file=sys.stderr)
        return 0
    t1 = time.time()
    sa = suffix_array(symbols)
    dt = time.time() - t1
    print(f"[build_index] suffix sort: {dt:.1f}s "
          f"({len(symbols) / max(dt, 1e-9) / 1e6:.1f} Mbp/s)",
          file=sys.stderr)
    bi = not args.sa_mono
    fm_fields, ssa_fields = build_fm_arrays(
        symbols, sa_sample=args.sa_sample, sa=sa, bi_sample=bi)
    del sa
    lut = build_kmer_lut(symbols, k=args.lut_k) if args.lut_k > 0 else None
    save_index(args.output, fm_fields, ssa_fields, symbols.astype("int8"),
               g["names"], g["lens"], args.sa_sample, sa_bi=int(bi),
               lut=lut, lut_k=args.lut_k, amb=g["amb"])
    if args.pac:
        write_pac(args.pac, symbols)
    print(f"[build_index] wrote {args.output} in {time.time() - t0:.1f}s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
