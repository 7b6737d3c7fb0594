"""FASTQ reader/writer (plain or gzip) with batch iteration.

Ref parity: nvbio/io/sequence/sequence_fastq.cpp + the batch semantics
of ``SequenceDataStream::next(max_reads, max_bps)`` used by nvBowtie's
InputThread (ref: nvBowtie/bowtie2/cuda/input_thread.cpp).

A copy of ``nvbio_tpu/io/fastq.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import gzip

import numpy as np

from ..basic.alphabet import char_to_dna, dna_to_char


def _qual_decoder(qual_enc: str):
    """Byte -> Phred conversion for the supported encodings (ref:
    nvbio/io/sequence/sequence.h Phred33/Phred64/Solexa64 QualityEncoding).

    phred33 (default), phred64 (Illumina 1.3-1.7), solexa64 (pre-1.3:
    byte-64 is a *Solexa* odds score; converted via
    phred = 10*log10(1 + 10^(solexa/10)))."""
    if qual_enc == "phred33":
        return lambda b: b - 33
    if qual_enc == "phred64":
        return lambda b: b - 64
    if qual_enc == "solexa64":
        sol = np.arange(256, dtype=np.float64) - 64.0
        lut = np.round(
            10.0 * np.log10(1.0 + 10.0 ** (sol / 10.0))
        ).astype(np.uint8)
        return lambda b: lut[b]
    raise ValueError(f"unknown quality encoding {qual_enc!r}")


def _open(path, mode="rt"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fastq(path, qual_enc: str = "phred33"):
    """Parse an entire FASTQ file -> (names, seqs, quals) lists.

    seqs are uint8 symbol arrays (0..4), quals are uint8 Phred scores.
    """
    names, seqs, quals = [], [], []
    for n, s, q in iter_fastq(path, qual_enc=qual_enc):
        names.append(n)
        seqs.append(s)
        quals.append(q)
    return names, seqs, quals


def iter_fastq(path, qual_enc: str = "phred33"):
    dec = _qual_decoder(qual_enc)
    with _open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            seq = f.readline().strip()
            f.readline()  # '+'
            qual = f.readline().strip()
            name = hdr.strip()[1:].split()[0]
            s = char_to_dna(np.frombuffer(seq.encode(), dtype=np.uint8))
            q = dec(np.frombuffer(qual.encode(), dtype=np.uint8))
            yield name, s, q


class FastqBatchReader:
    """Iterate a FASTQ file in fixed-size read batches (the input side
    of the mapper pipeline; CPU thread overlap comes later)."""

    def __init__(self, path, batch_size: int,
                 qual_enc: str = "phred33"):
        self._it = iter_fastq(path, qual_enc=qual_enc)
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def __next__(self):
        names, seqs, quals = [], [], []
        for _ in range(self.batch_size):
            try:
                n, s, q = next(self._it)
            except StopIteration:
                break
            names.append(n)
            seqs.append(s)
            quals.append(q)
        if not names:
            raise StopIteration
        return names, seqs, quals


def read_fastq_packed(path, max_len: int):
    """Whole-file FASTQ -> padded batch matrices via the native C++
    parser (ref: sequence_fastq.cpp host-speed path), falling back to
    the Python parser.  Returns (names, reads (R, max_len) int8, lens,
    quals)."""
    raw = _open(path, "rb").read()
    from ..native import fastq_parse_native

    out = fastq_parse_native(raw, max_len)
    if out is not None:
        return out
    from ..strings.string_set import pack_reads

    names, seqs, quals = read_fastq(path)
    reads, lens, qmat, _ = pack_reads(seqs, quals, max_len=max_len)
    return names, reads, lens, qmat


def write_fastq(path, records):
    """records: iterable of (name, symbols, quals)."""
    with _open(path, "wt") as f:
        for name, sym, q in records:
            seq = dna_to_char(np.asarray(sym, dtype=np.uint8)).tobytes().decode()
            qs = (np.asarray(q, dtype=np.uint8) + 33).tobytes().decode()
            f.write(f"@{name}\n{seq}\n+\n{qs}\n")
