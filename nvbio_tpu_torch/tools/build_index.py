"""Index builder CLI (nvBWT + nvSSA equivalent).

Port of ``nvbio_tpu/tools/build_index.py``: FASTA -> concatenation +
seeded N substitution -> suffix sort -> BWT, blocked occ tables,
sampled SA, k-mer LUT -> one ``.npz`` in the reference's format (it
loads in both packages), or, with ``--shard-bp``, a sharded index for
references past one int32 index (``<prefix>.manifest.json``, one
``.npz`` per shard and ``<prefix>.genome.npy``, the reference's files):

    python -m nvbio_tpu_torch.tools.build_index ref.fa ref.npz
    python -m nvbio_tpu_torch.tools.build_index ref.fa ref.npz \\
        --algorithm device --device-occ          # sort and occ on the GPU
    python -m nvbio_tpu_torch.tools.build_index hg38.fa hg38 \\
        --shard-bp 1600000000 --procs 2

The suffix sort is native SA-IS (``auto``, ``sais``), NumPy prefix
doubling (``pd``) or the device sort (``device``: whole-text prefix
doubling up to 8 Mbp, the bucketed chunked sort above).  The device
stages (``--algorithm device``, ``--device-occ``) run on ``--device``;
everything else runs on the host.  With ``--shard-bp`` the
``--algorithm`` is ignored, as in the reference: each shard is sorted
by SA-IS.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


# the largest text the whole-text device prefix doubling takes; above
# it the bucketed sort (the reference's threshold)
DEVICE_PD_MAX_BP = 8_000_000


def suffix_sort(symbols, algorithm, device):
    """The suffix array of ``symbols`` by ``algorithm`` (auto, sais, pd,
    device), the device sorts on ``device``."""
    from ..sufsort import sa as host

    if algorithm == "auto":
        return host.suffix_array(symbols)
    if algorithm == "sais":
        from ..native import sais_native

        sa = sais_native(symbols.astype("uint8"))
        if sa is None:
            print("[build_index] no C++ toolchain; using prefix doubling",
                  file=sys.stderr)
            sa = host.suffix_array_pd(symbols)
        return sa
    if algorithm == "pd":
        return host.suffix_array_pd(symbols)
    if len(symbols) <= DEVICE_PD_MAX_BP:
        from ..sufsort.device import suffix_array_device

        return suffix_array_device(symbols, device)
    from ..sufsort.bucketed import suffix_array_bucketed

    return suffix_array_bucketed(symbols, verbose=True, device=device)


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
                   help="suffix sort: native C++ SA-IS (any size), NumPy "
                   "prefix-doubling, or the on-device sort (bucketed "
                   "chunked sort at shard scale; texts up to 8 Mbp use "
                   "whole-text device prefix-doubling)")
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
                   help="compute the blocked occ tables on --device "
                   "(packed BWT up, occ tables down; bit-identical to the "
                   "host path; the workers of a --procs build count on "
                   "the host)")
    p.add_argument("--accelerator", action="store_true",
                   help="accepted for the reference's command lines; "
                   "changes nothing: the host stages never touch a "
                   "device and the device stages run on --device")
    p.add_argument("--device", default="cuda",
                   help="device of the device stages (--algorithm device, "
                   "--device-occ): cuda (default) or cpu; unused "
                   "otherwise")
    args = p.parse_args(argv)
    device = None
    if args.algorithm == "device" or args.device_occ:
        from ..device import resolve_device

        device = resolve_device(args.device)

    from ..io.fasta import read_fasta
    from ..io.genome import prepare_genome

    from ..fmindex.build import build_fm_arrays, build_kmer_lut
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
            n_procs=n_procs, occ_device=args.device_occ, device=device)
        save_sharded_index(prefix, sidx, symbols.astype("int8"), g["names"],
                           g["lens"])
        print(f"[build_index] wrote {len(sidx.shards)}-shard index "
              f"{prefix}.manifest.json in {time.time() - t0:.1f}s",
              file=sys.stderr)
        return 0
    t1 = time.time()
    sa = suffix_sort(symbols, args.algorithm, device)
    dt = time.time() - t1
    alg = "" if args.algorithm == "auto" else f" ({args.algorithm})"
    print(f"[build_index] suffix sort{alg}: {dt:.1f}s "
          f"({len(symbols) / max(dt, 1e-9) / 1e6:.1f} Mbp/s)",
          file=sys.stderr)
    bi = not args.sa_mono
    fm_fields, ssa_fields = build_fm_arrays(
        symbols, sa_sample=args.sa_sample, sa=sa, bi_sample=bi,
        occ_device=args.device_occ, device=device)
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
