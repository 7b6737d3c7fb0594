"""FASTA reader/writer (plain or gzip).

Ref parity: nvbio/io/sequence/sequence_fasta.cpp (FASTA loader used by
nvBWT for the genome).

A copy of ``nvbio_tpu/io/fasta.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import gzip

import numpy as np

from ..basic.alphabet import encode_dna, decode_dna


def _open(path, mode="rt"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path) -> list[tuple[str, np.ndarray]]:
    """Parse a FASTA file -> [(name, symbols uint8 0..4)].

    Whole-buffer vectorized parse: one read, header scan via substring
    find, newline strip as a NumPy mask — a 3 GB genome parses in
    seconds where the old per-line Python loop churned minutes of GC
    and sys time (44M small strings at hg scale)."""
    from ..basic.alphabet import char_to_dna

    with _open(path, "rb") as f:
        data = f.read()
    out = []
    pos = data.find(b">")
    while pos >= 0:
        nl = data.find(b"\n", pos)
        if nl < 0:
            break
        name = data[pos + 1:nl].split()[0].decode()
        nxt = data.find(b"\n>", nl)
        end = len(data) if nxt < 0 else nxt + 1
        arr = np.frombuffer(data[nl + 1:end], dtype=np.uint8)
        arr = arr[(arr != 10) & (arr != 13)]  # strip \n, \r
        out.append((name, char_to_dna(arr)))
        pos = -1 if nxt < 0 else nxt + 1
    return out


def read_fasta_text(path) -> list[tuple[str, str]]:
    """Parse a FASTA file -> [(name, raw sequence string)] — for
    non-DNA alphabets (protein FASTA, ref: proteinsw example input)."""
    out = []
    name = None
    chunks: list[str] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        out.append((name, "".join(chunks)))
    return out


def write_fasta(path, seqs, width: int = 70):
    """seqs: iterable of (name, symbol array)."""
    with _open(path, "wt") as f:
        for name, sym in seqs:
            f.write(f">{name}\n")
            s = decode_dna(sym)
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")
