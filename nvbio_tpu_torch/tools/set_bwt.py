"""Set-BWT builder CLI (nvSetBWT equivalent).

Port of ``nvbio_tpu/tools/set_bwt.py``: the BWT of a *collection of
reads* (each read followed by its own sentinel, sentinels ordered by
read id), built on ``--device`` by ``sufsort.set_bwt_device`` and
written as ``.npy`` uint8 symbols or ``.txt`` over {A,C,G,T,$}:

    python -m nvbio_tpu_torch.tools.set_bwt reads.fq bwt.npy
    python -m nvbio_tpu_torch.tools.set_bwt reads.fq bwt.txt --device cpu

Ref parity: the reference's set-BWT tool over nvbio/sufsort/bwte.h
(``BWTEContext``, the incremental merge of arXiv:1410.0562); the
bounded suffix depth of short reads lets one fixed series of LSD radix
sorts replace the merge (sufsort/device.py).  N bases count as A, as
in the reference.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="set_bwt", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("reads", help="input FASTQ (.fq/.fq.gz)")
    p.add_argument("output", help="output BWT (.npy of uint8 symbols, "
                   "or .txt for ACGT$ text)")
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never picked implicitly")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..io.fastq import read_fastq_packed
    from ..sufsort.device import set_bwt_device

    device = resolve_device(args.device)
    t0 = time.time()
    _names, reads, lens, _quals = read_fastq_packed(args.reads,
                                                    max_len=args.max_len)
    n_bases = int(lens.sum())
    bwt = set_bwt_device(np.where(reads < 4, reads, 0).astype(np.uint8),
                         lens, device)
    dt = time.time() - t0
    if args.output.endswith(".txt"):
        sym = np.frombuffer(b"ACGT$", dtype=np.uint8)
        with open(args.output, "wb") as f:
            f.write(sym[bwt].tobytes())
    else:
        np.save(args.output, bwt)
    print(f"[set_bwt] {len(lens)} reads, {n_bases} bases -> "
          f"{len(bwt)} BWT symbols in {dt:.1f}s "
          f"({n_bases/dt/1e6:.1f} Mbases/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
