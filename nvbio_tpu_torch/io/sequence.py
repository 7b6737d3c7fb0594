"""Format-sniffing read input: FASTQ / FASTA / SAM / BAM / TXT.

Ref parity: nvbio/io/sequence — ``open_sequence_file()`` dispatches on
format so any supported file can feed the mappers; SAM/BAM input is the
re-alignment path (sequence_sam.cpp / sequence_bam.cpp): records with
FLAG 0x10 are reverse-complemented back to original read orientation.
TXT = one raw sequence per line (sequence_txt.cpp).

A copy of ``nvbio_tpu/io/sequence.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import gzip

import numpy as np

from ..basic.alphabet import char_to_dna, reverse_complement

FLAG_REVERSE = 0x10
FLAG_SECONDARY_OR_SUPP = 0x900


def _open(path, mode="rt"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _strip_gz(path):
    p = str(path)
    return p[:-3] if p.endswith(".gz") else p


def iter_sam_reads(path):
    """(name, symbols, quals) from SAM records (primary lines only)."""
    with _open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.rstrip("\n").split("\t")
            flag = int(c[1])
            if flag & FLAG_SECONDARY_OR_SUPP:
                continue
            seq, qual = c[9], c[10]
            if seq == "*":
                continue
            sym = char_to_dna(np.frombuffer(seq.encode(), dtype=np.uint8))
            q = (np.frombuffer(qual.encode(), dtype=np.uint8) - 33
                 if qual != "*" else np.full(len(sym), 40, np.uint8))
            if flag & FLAG_REVERSE:
                sym = reverse_complement(sym)
                q = q[::-1]
            yield c[0], sym, q


def iter_bam_reads(path):
    from .bam import read_bam

    _text, _names, recs = read_bam(path)
    for r in recs:
        if r["flag"] & FLAG_SECONDARY_OR_SUPP or not r["seq"]:
            continue
        sym = char_to_dna(
            np.frombuffer(r["seq"].encode(), dtype=np.uint8))
        q = np.frombuffer(r["qual"].encode(), dtype=np.uint8) - 33
        if r["flag"] & FLAG_REVERSE:
            sym = reverse_complement(sym)
            q = q[::-1]
        yield r["qname"], sym, q


def iter_fasta_reads(path):
    from .fasta import read_fasta

    for name, sym in read_fasta(path):
        yield name, sym, np.full(len(sym), 40, np.uint8)


def iter_txt_reads(path):
    """One raw sequence per line (ref: sequence_txt.cpp)."""
    i = 0
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            sym = char_to_dna(
                np.frombuffer(line.encode(), dtype=np.uint8))
            yield f"txt_{i}", sym, np.full(len(sym), 40, np.uint8)
            i += 1


def open_read_iter(path, qual_enc: str = "phred33"):
    """Pick a reader by extension (ref: open_sequence_file sniffing).
    ``qual_enc`` applies to FASTQ (other formats carry Phred33 or no
    qualities)."""
    base = _strip_gz(path).lower()
    if base.endswith((".fq", ".fastq")):
        from .fastq import iter_fastq

        return iter_fastq(path, qual_enc=qual_enc)
    if base.endswith((".fa", ".fasta", ".fna")):
        return iter_fasta_reads(path)
    if base.endswith(".sam"):
        return iter_sam_reads(path)
    if base.endswith(".bam"):
        return iter_bam_reads(path)
    if base.endswith(".txt"):
        return iter_txt_reads(path)
    raise ValueError(f"unrecognized read-file format: {path}")


class ReadBatchIterator:
    """Batch any supported format into (names, seqs, quals) lists —
    the generic version of FastqBatchReader (InputThread equivalent)."""

    def __init__(self, path, batch_size: int,
                 qual_enc: str = "phred33"):
        self.it = open_read_iter(path, qual_enc=qual_enc)
        self.batch_size = batch_size

    def __iter__(self):
        names, seqs, quals = [], [], []
        for n, s, q in self.it:
            names.append(n)
            seqs.append(s)
            quals.append(q)
            if len(names) == self.batch_size:
                yield names, seqs, quals
                names, seqs, quals = [], [], []
        if names:
            yield names, seqs, quals
