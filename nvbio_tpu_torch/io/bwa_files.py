"""BWA-layout index file interop: .bwt/.sa/.ann/.amb (+ .pac in
index_file.py).

Ref parity: SURVEY.md Appendix A requires a converter between our
.npz container and the BWA-style files the reference reads/writes
(upstream io/fmindex/fmindex.cpp loads .bwt/.sa produced by nvBWT;
.ann/.amb follow BWA's bntseq.c text formats).  With these, any
BWA-compatible external aligner or the reference itself can be
cross-validated against our index in one command
(tools/bwa_export.py / tools/bwa_import.py).

Formats (BWA 0.7.x, little-endian, bwtint = uint64):

.bwt   primary u64 | L2[1..4] u64 x4 | packed BWT u32 words,
       16 bases/word, base k at bit shift ((~k & 15) << 1).  The BWT
       string has the sentinel row REMOVED (length == seq_len);
       `primary` is the row where the sentinel would sit.
.sa    primary u64 | L2[1..4] u64 x4 | sa_intv u64 | seq_len u64 |
       SA[k*intv] for k = 1..n_sa-1 (row-sampled; sa[0] = sentinel
       row is implicit and skipped).
.ann   text: "l_pac n_seqs seed\n" then per sequence
       "gi name (comment)\n offset len n_ambs\n".
.amb   text: "l_pac n_seqs n_holes\n" then "offset len base\n" per
       ambiguity run.
"""

from __future__ import annotations

import numpy as np

_BWTINT = np.dtype("<u8")


def _pack_bwa_2bit_words(syms: np.ndarray) -> np.ndarray:
    """16 bases per little-endian u32, base k at shift ((~k & 15) << 1)
    (bwt_B0 layout)."""
    syms = np.asarray(syms, dtype=np.uint32) & 3
    n = len(syms)
    n_words = (n + 15) // 16
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:n] = syms
    lanes = padded.reshape(n_words, 16)
    shifts = ((15 - np.arange(16)) * 2).astype(np.uint32)
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype("<u4")


def _unpack_bwa_2bit_words(words: np.ndarray, n: int) -> np.ndarray:
    words = np.asarray(words, dtype=np.uint32)
    shifts = ((15 - np.arange(16)) * 2).astype(np.uint32)
    syms = ((words[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return syms[:n].astype(np.uint8)


def write_bwt(path, bwt_syms: np.ndarray, primary: int, C: np.ndarray):
    """bwt_syms: BWT string with the sentinel row removed (uint8 0..3,
    length seq_len).  C: cumulative counts with C[0] == 0; BWA's
    L2[1..4] = cumulative count *through* each symbol."""
    bwt_syms = np.asarray(bwt_syms, dtype=np.uint8)
    n = len(bwt_syms)
    counts = np.bincount(bwt_syms, minlength=4)[:4]
    L2 = np.cumsum(counts).astype(_BWTINT)
    assert int(L2[-1]) == n
    with open(path, "wb") as f:
        f.write(np.asarray([primary], dtype=_BWTINT).tobytes())
        f.write(L2.tobytes())
        f.write(_pack_bwa_2bit_words(bwt_syms).tobytes())


def read_bwt(path):
    """Returns (bwt_syms uint8 (seq_len,), primary, L2[1..4])."""
    raw = open(path, "rb").read()
    primary = int(np.frombuffer(raw[:8], _BWTINT)[0])
    L2 = np.frombuffer(raw[8:40], _BWTINT).astype(np.int64)
    n = int(L2[-1])
    words = np.frombuffer(raw[40:], "<u4")
    return _unpack_bwa_2bit_words(words, n), primary, L2


def write_sa(path, sa_sampled: np.ndarray, sa_intv: int, primary: int,
             L2: np.ndarray, seq_len: int):
    """sa_sampled: SA[k * sa_intv] for k = 1..n_sa-1 (row 0 skipped)."""
    with open(path, "wb") as f:
        f.write(np.asarray([primary], dtype=_BWTINT).tobytes())
        f.write(np.asarray(L2, dtype=_BWTINT).tobytes())
        f.write(np.asarray([sa_intv, seq_len], dtype=_BWTINT).tobytes())
        f.write(np.asarray(sa_sampled, dtype=_BWTINT).tobytes())


def read_sa(path):
    """Returns dict(primary, L2, sa_intv, seq_len, sa) with sa the
    row-sampled values for rows intv, 2*intv, ... (row 0 excluded)."""
    raw = open(path, "rb").read()
    hdr = np.frombuffer(raw[:56], _BWTINT)
    sa = np.frombuffer(raw[56:], _BWTINT).astype(np.int64)
    return {
        "primary": int(hdr[0]),
        "L2": hdr[1:5].astype(np.int64),
        "sa_intv": int(hdr[5]),
        "seq_len": int(hdr[6]),
        "sa": sa,
    }


def write_ann(path, l_pac: int, names, lens, n_ambs_per_seq,
              seed: int = 11):
    lines = [f"{l_pac} {len(names)} {seed}"]
    off = 0
    for name, ln, na in zip(names, lens, n_ambs_per_seq):
        lines.append(f"0 {name} (null)")
        lines.append(f"{off} {int(ln)} {int(na)}")
        off += int(ln)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_ann(path):
    with open(path) as f:
        toks = f.read().split("\n")
    l_pac, n_seqs, seed = (int(x) for x in toks[0].split()[:3])
    names, lens, offs, nambs = [], [], [], []
    for i in range(n_seqs):
        name_line = toks[1 + 2 * i].split()
        names.append(name_line[1])
        off, ln, na = (int(x) for x in toks[2 + 2 * i].split()[:3])
        offs.append(off)
        lens.append(ln)
        nambs.append(na)
    return {"l_pac": l_pac, "seed": seed, "names": names,
            "lens": lens, "offsets": offs, "n_ambs": nambs}


def write_amb(path, l_pac: int, n_seqs: int, holes):
    """holes: [(offset, length, base_char)]."""
    lines = [f"{l_pac} {n_seqs} {len(holes)}"]
    for off, ln, ch in holes:
        lines.append(f"{int(off)} {int(ln)} {ch}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_amb(path):
    with open(path) as f:
        toks = [l for l in f.read().split("\n") if l]
    l_pac, n_seqs, n_holes = (int(x) for x in toks[0].split()[:3])
    holes = []
    for i in range(n_holes):
        off, ln, ch = toks[1 + i].split()
        holes.append((int(off), int(ln), ch))
    return {"l_pac": l_pac, "n_seqs": n_seqs, "holes": holes}


def bwt_from_index(fm) -> np.ndarray:
    """Unpack our FMIndex's stored BWT (which carries a dummy 'A' in
    the sentinel row) and remove the sentinel row — the BWA .bwt
    string.  Host NumPy."""
    words = np.asarray(fm.bwt_words).reshape(-1)
    shifts = (2 * np.arange(16)).astype(np.uint32)
    syms = ((words[:, None] >> shifts[None, :]) & 3).astype(np.uint8)
    syms = syms.reshape(-1)
    n = int(np.asarray(fm.n))
    primary = int(np.asarray(fm.primary))
    m = syms[: n + 1]
    return np.concatenate([m[:primary], m[primary + 1:]])
