"""MEM-seeded mapper CLI (nvMem equivalent): index + single-end reads
-> SAM, with SMEM seeding (option names follow BWA-MEM where they exist:
-k, the minimum seed length).

Port of ``nvbio_tpu/tools/mem_map.py`` with an explicit ``--device``
in place of ``--cpu``:

    python -m nvbio_tpu_torch.tools.mem_map -x ref.npz -U reads.fq \\
        -S out.sam --device cuda
    python -m nvbio_tpu_torch.tools.mem_map -x ref.npz -U reads.fq \\
        -S out.bam --device cuda -k 25 --max-smems 4 --local

-S writes BAM for a .bam path and SAM (.gz ok) else.  --stats writes
the reference's MappingStats summary plus the port's device, load_s,
map_s and reads_per_s.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="mem_map", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-x", "--index", required=True, help="index .npz")
    p.add_argument("-U", required=True, help="reads FASTQ(.gz)")
    p.add_argument("-S", "--sam", required=True,
                   help="output SAM (.gz ok), or BAM for a .bam path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never picked implicitly")
    p.add_argument("-k", "--min-mem-len", type=int, default=19)
    p.add_argument("--max-smems", type=int, default=8,
                   help="SMEMs kept a read strand, longest first")
    p.add_argument("--max-read-len", type=int, default=320)
    p.add_argument("--local", action="store_true")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--stats", help="write stats JSON here")
    args = p.parse_args(argv)

    from ..models.mem_mapper import MemMapper
    from ._single_end import run

    def make(fm, ssa, genome, params, contigs):
        return MemMapper(fm, ssa, genome, params=params, contigs=contigs)

    return run(args, argv, "tpu_mem", make, min_mem_len=args.min_mem_len,
               max_smems=args.max_smems)


if __name__ == "__main__":
    sys.exit(main())
