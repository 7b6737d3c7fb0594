"""Q-gram-seeded mapper CLI (examples/qmap equivalent): index +
single-end reads -> SAM, with q-gram seeding; the q-gram index is built
in memory from the genome stored in the index container.

Port of ``nvbio_tpu/tools/qmap.py`` with an explicit ``--device`` in
place of ``--cpu``:

    python -m nvbio_tpu_torch.tools.qmap -x ref.npz -U reads.fq \\
        -S out.sam --device cuda
    python -m nvbio_tpu_torch.tools.qmap -x ref.npz -U reads.fq \\
        -S out.sam --device cuda -q 12 --stride 5 --max-hits 4

-S writes BAM for a .bam path and SAM (.gz ok) else.  --stats writes
the reference's MappingStats summary plus the port's device, load_s
(the q-gram build included), map_s and reads_per_s.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="qmap", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-x", "--index", required=True, help="index .npz")
    p.add_argument("-U", required=True, help="reads FASTQ(.gz)")
    p.add_argument("-S", "--sam", required=True,
                   help="output SAM (.gz ok), or BAM for a .bam path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never picked implicitly")
    p.add_argument("-q", "--gram", type=int, default=14,
                   help="q-gram length")
    p.add_argument("--stride", type=int, default=8,
                   help="read q-gram sampling stride")
    p.add_argument("--max-hits", type=int, default=8)
    p.add_argument("--max-read-len", type=int, default=320)
    p.add_argument("--local", action="store_true")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--stats", help="write stats JSON here")
    args = p.parse_args(argv)

    from ..models.qgram_mapper import QGramMapper
    from ._single_end import run

    def make(fm, ssa, genome, params, contigs):
        return QGramMapper(fm, ssa, genome, q=args.gram, stride=args.stride,
                           max_hits=args.max_hits, params=params,
                           contigs=contigs)

    return run(args, argv, "tpu_qmap", make)


if __name__ == "__main__":
    sys.exit(main())
