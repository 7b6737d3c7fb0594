"""BAM output with BGZF compression (+ a minimal BAM reader).

Ref parity: nvbio/io/output/output_bam.cpp (``BamOutput``) and the
contrib zlib BGZF path (SURVEY.md §3.7, §3.10).  BGZF blocks are gzip
members with a BC extra subfield carrying the compressed block size, so
standard gzip tools can read the stream; the 28-byte EOF marker ends
the file.  Encoding follows the SAM/BAM spec v1.6.

A copy of ``nvbio_tpu/io/bam.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import struct
import zlib

from .sam import SamRecord

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODE = {0: 1, 1: 2, 2: 4, 3: 8, 4: 15}  # A C G T N -> 4-bit nibbles
_CHAR_TO_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1  # header(12) + XLEN block(6) + footer(8)
    header = struct.pack(
        "<4BI2BH2B2H",
        0x1F, 0x8B, 8, 4,  # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,  # mtime, xfl, os
        6,  # XLEN
        ord("B"), ord("C"), 2, bsize - 1,
    )
    footer = struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)
    return header + cdata + footer


class BgzfWriter:
    """Blocked gzip writer (<= 64 KiB of payload per block)."""

    def __init__(self, path):
        self._f = open(path, "wb")
        self._buf = bytearray()

    def write(self, data: bytes):
        self._buf.extend(data)
        while len(self._buf) >= 0xFF00:
            self._flush_block(0xFF00)

    def _flush_block(self, n=None):
        n = len(self._buf) if n is None else n
        if n:
            data = bytes(self._buf[:n])
            from ..native import bgzf_compress_native

            out = bgzf_compress_native(data)
            self._f.write(out if out is not None else bgzf_block(data))
            del self._buf[:n]

    def close(self):
        self._flush_block()
        self._f.write(_BGZF_EOF)
        self._f.close()


def reg2bin(beg: int, end: int) -> int:
    """BAM spec bin computation."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _parse_cigar(cigar: str):
    ops = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            ops.append((int(num), _CIGAR_OPS.index(ch)))
            num = ""
    return ops


class BamWriter:
    """BAM encoder over BGZF (API mirrors SamWriter)."""

    def __init__(self, path, ref_names, ref_lens, program="tpu_bowtie",
                 version="0.1.0", cmdline="", rg_line: str | None = None):
        self._w = BgzfWriter(path)
        self._refs = {n: i for i, n in enumerate(ref_names)}
        text = "@HD\tVN:1.6\tSO:unsorted\n"
        for n, l in zip(ref_names, ref_lens):
            text += f"@SQ\tSN:{n}\tLN:{l}\n"
        if rg_line:  # read group (bowtie2 --rg-id/--rg)
            text += rg_line.rstrip("\n") + "\n"
        text += f"@PG\tID:{program}\tPN:{program}\tVN:{version}\tCL:{cmdline}\n"
        hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
        self._w.write(hdr)

    def write(self, rec: SamRecord):
        ref_id = self._refs.get(rec.rname, -1)
        pos = rec.pos - 1
        name = rec.qname.encode() + b"\x00"
        cig = [] if rec.cigar == "*" else _parse_cigar(rec.cigar)
        seq = rec.seq if rec.seq != "*" else ""
        l_seq = len(seq)
        nib = [_CHAR_TO_NIBBLE.get(c, 15) for c in seq]
        if l_seq % 2:
            nib.append(0)
        seq_b = bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))
        qual_b = (bytes((min(ord(c) - 33, 93) for c in rec.qual))
                  if rec.qual != "*" else b"\xff" * l_seq)
        ref_span = sum(n for n, op in cig if _CIGAR_OPS[op] in "MDN=X")
        bin_ = reg2bin(max(pos, 0), max(pos, 0) + max(ref_span, 1))
        next_ref = (ref_id if rec.rnext == "=" else
                    self._refs.get(rec.rnext, -1))
        # layout per spec: refID pos l_read_name mapq bin n_cigar_op
        # flag l_seq next_refID next_pos tlen
        data = struct.pack(
            "<ii2B3Hi3i",
            ref_id, pos, len(name), rec.mapq, bin_, len(cig), rec.flag,
            l_seq, next_ref, rec.pnext - 1, rec.tlen,
        )
        data += name
        for n, op in cig:
            data += struct.pack("<I", (n << 4) | op)
        data += seq_b + qual_b
        for tag, ty, val in rec.tags:
            if ty == "i":
                data += tag.encode() + b"i" + struct.pack("<i", int(val))
            elif ty == "Z":
                data += tag.encode() + b"Z" + str(val).encode() + b"\x00"
        self._w.write(struct.pack("<i", len(data)) + data)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_bam(path):
    """Minimal BAM reader (tests + SAM/BAM re-alignment input parity,
    ref: io/sequence/sequence_bam.cpp).  Returns (header_text,
    ref_names, records as dicts)."""
    import gzip

    raw = gzip.open(path, "rb").read()
    assert raw[:4] == b"BAM\x01"
    off = 4
    (l_text,) = struct.unpack_from("<i", raw, off)
    off += 4
    text = raw[off : off + l_text].decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", raw, off)
    off += 4
    names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, off)
        off += 4
        names.append(raw[off : off + l_name - 1].decode())
        off += l_name + 4  # skip l_ref
    recs = []
    while off < len(raw):
        (block,) = struct.unpack_from("<i", raw, off)
        off += 4
        end = off + block
        (ref_id, pos, l_name, mapq, bin_, n_cig, flag, l_seq, next_ref,
         next_pos, tlen) = struct.unpack_from("<ii2B3Hi3i", raw, off)
        p = off + 32
        qname = raw[p : p + l_name - 1].decode()
        p += l_name
        cig = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", raw, p)
            cig.append(f"{v >> 4}{_CIGAR_OPS[v & 15]}")
            p += 4
        seq_nib = raw[p : p + (l_seq + 1) // 2]
        p += (l_seq + 1) // 2
        seq = ""
        for i in range(l_seq):
            nb = (seq_nib[i // 2] >> (4 if i % 2 == 0 else 0)) & 15
            seq += "=ACMGRSVTWYHKDBN"[nb]
        qual = bytes(q + 33 for q in raw[p : p + l_seq]).decode()
        p += l_seq
        tags = {}
        while p < end:
            tag = raw[p : p + 2].decode()
            ty = chr(raw[p + 2])
            p += 3
            if ty == "i":
                (v,) = struct.unpack_from("<i", raw, p)
                p += 4
                tags[tag] = v
            elif ty == "Z":
                z = raw.index(b"\x00", p)
                tags[tag] = raw[p:z].decode()
                p = z + 1
            else:
                break  # unsupported type: stop tag parsing
        recs.append({
            "qname": qname, "flag": flag, "ref_id": ref_id, "pos": pos,
            "mapq": mapq, "cigar": "".join(cig) or "*", "seq": seq,
            "qual": qual, "tlen": tlen, "next_pos": next_pos,
            "tags": tags,
        })
        off = end
    return text, names, recs
