"""Ordered multi-shard SAM merge CLI.

Concatenates per-host SAM shards in shard order (header from shard 0),
producing output bit-identical to a single-host run over the unsharded
input — the deterministic multi-host output path (SURVEY.md §5.8,
§7.3(6)).  The reference has no equivalent (it is single-node); this is
the DCN-side half of the TPU scale-out design.

Port of ``nvbio_tpu/tools/sam_merge.py`` on the port's
``parallel.distributed.merge_sam_shards``:

    python -m nvbio_tpu_torch.tools.sam_merge shard0.sam shard1.sam \\
        -o merged.sam
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="sam_merge", description=__doc__)
    p.add_argument("shards", nargs="+", help="per-shard SAM files, in order")
    p.add_argument("-o", "--out", required=True, help="merged SAM")
    args = p.parse_args(argv)

    from ..parallel.distributed import merge_sam_shards

    n = merge_sam_shards(args.shards, args.out)
    print(f"[sam_merge] {len(args.shards)} shards -> {args.out} "
          f"({n} records)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
