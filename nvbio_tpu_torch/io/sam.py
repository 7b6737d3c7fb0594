"""SAM output.

Ref parity: nvbio/io/output/output_sam.cpp (``SamOutput``) — header
with @HD/@SQ/@PG, one record per read with FLAG/MAPQ/CIGAR/MD/AS/XS/NM
tags matching the reference's emitted tag set.  BAM/BGZF is staged
work (output_bam.cpp equivalent).

A copy of ``nvbio_tpu/io/sam.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int  # 1-based leftmost mapping position (0 if unmapped)
    mapq: int
    cigar: str
    seq: str
    qual: str
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    tags: list = field(default_factory=list)  # [(TAG, TYPE, value)]

    def to_line(self) -> str:
        cols = [
            self.qname,
            str(self.flag),
            self.rname,
            str(self.pos),
            str(self.mapq),
            self.cigar,
            self.rnext,
            str(self.pnext),
            str(self.tlen),
            self.seq,
            self.qual,
        ]
        cols.extend(f"{t}:{ty}:{v}" for t, ty, v in self.tags)
        return "\t".join(cols)


class SamWriter:
    """Streaming SAM text writer (plain or .gz)."""

    def __init__(self, path, ref_names, ref_lens, program="tpu_bowtie",
                 version="0.1.0", cmdline="", append=False,
                 rg_line: str | None = None):
        path = str(path)
        if append:  # shard-restart resume: keep the existing header
            self._f = open(path, "a")
            return
        self._f = gzip.open(path, "wt") if path.endswith(".gz") else open(
            path, "w"
        )
        self._f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for name, ln in zip(ref_names, ref_lens):
            self._f.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
        if rg_line:  # read group (bowtie2 --rg-id/--rg)
            self._f.write(rg_line.rstrip("\n") + "\n")
        self._f.write(
            f"@PG\tID:{program}\tPN:{program}\tVN:{version}\tCL:{cmdline}\n"
        )

    def write(self, rec: SamRecord):
        self._f.write(rec.to_line() + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
