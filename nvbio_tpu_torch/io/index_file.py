"""Index container: save/load FM-index + SSA + genome (+ contig table,
k-mer LUT) as one ``.npz``, in the format of
``nvbio_tpu/io/index_file.py`` (whose loader builds JAX arrays).  Files
written by either package load in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..fmindex.index import FMIndex, SSA

FORMAT_VERSION = 1


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x, device, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:  # np.load / mmap arrays: torch wants a copy
        a = a.copy()
    if a.dtype == np.uint32:  # keep the bits; torch's uint32 is thin
        a = a.view(np.int32)
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def index_from_numpy(fm_fields, ssa_fields, genome, lut=None,
                     device="cpu"):
    """Numpy index arrays -> the port's tensors on ``device``.

    ``fm_fields`` = (bwt_words, occ_abs, occ_sub, C, primary, n) and
    ``ssa_fields`` = (mark_words, mark_abs, vals[, k, bi]) in the field
    order of ``nvbio_tpu``'s FMIndex/SSA (``np.asarray`` of each field
    of a JAX index works as is).  Returns (fm, ssa, genome int8 numpy,
    lut as a pair of int32 tensors or None)."""
    bwt_words, occ_abs, occ_sub, C, primary, n = list(fm_fields)[:6]
    fm = FMIndex(
        bwt_words=_t(bwt_words, device), occ_abs=_t(occ_abs, device),
        occ_sub=_t(occ_sub, device), C=_t(C, device, torch.int64),
        primary=int(primary), n=int(n))
    ssa_fields = list(ssa_fields)
    k = int(ssa_fields[3]) if len(ssa_fields) > 3 else 0
    bi = int(ssa_fields[4]) if len(ssa_fields) > 4 else 0
    ssa = SSA(mark_words=_t(ssa_fields[0], device),
              mark_abs=_t(ssa_fields[1], device),
              vals=_t(ssa_fields[2], device), k=k, bi=bi)
    if lut is not None:
        lut = (_t(lut[0], device), _t(lut[1], device))
    return fm, ssa, np.asarray(genome, dtype=np.int8), lut


def save_index(path, fm_fields, ssa_fields, genome: np.ndarray,
               contig_names, contig_lens, sa_sample: int, sa_bi: int = 0,
               lut=None, lut_k: int = 0, amb=None):
    """Write the ``.npz`` container.  ``fm_fields``/``ssa_fields`` as for
    index_from_numpy (numpy arrays or tensors)."""
    bwt_words, occ_abs, occ_sub, C, primary, n = list(fm_fields)[:6]
    mark_words, mark_abs, vals = list(ssa_fields)[:3]
    meta = {
        "version": FORMAT_VERSION,
        "sa_sample": int(sa_sample),
        "sa_bi": int(sa_bi),
        "lut_k": int(lut_k if lut is not None else 0),
        "contig_names": list(contig_names),
        "contig_lens": [int(x) for x in contig_lens],
        "amb": [[int(a), int(b)] for a, b in (amb or [])],
    }
    u32 = lambda x: _np(x).view(np.uint32)  # noqa: E731
    extra = {}
    if lut is not None:
        extra = {"lut_lo": _np(lut[0]), "lut_hi": _np(lut[1])}
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        genome=np.asarray(genome, dtype=np.int8),
        bwt_words=u32(bwt_words),
        occ_abs=_np(occ_abs).astype(np.int32),
        occ_sub=_np(occ_sub).astype(np.int8),
        C=_np(C).astype(np.int32),
        primary=np.asarray(int(primary), np.int32),
        n=np.asarray(int(n), np.int32),
        mark_words=u32(mark_words),
        mark_abs=_np(mark_abs).astype(np.int32),
        vals=_np(vals).astype(np.int32),
        **extra,
    )


def load_index(path, device="cpu"):
    """Returns (fm, ssa, genome np.int8, meta dict) with the index
    tensors on ``device``; ``meta["lut"]`` holds the LUT tensors when
    the file has one."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        meta.setdefault("lut_k", 0)
        lut = ((z["lut_lo"], z["lut_hi"]) if "lut_lo" in z.files else None)
        fm, ssa, genome, lut = index_from_numpy(
            [z[k] for k in ("bwt_words", "occ_abs", "occ_sub", "C",
                            "primary", "n")],
            [z["mark_words"], z["mark_abs"], z["vals"],
             meta.get("sa_sample", 0), meta.get("sa_bi", 0)],
            z["genome"], lut, device)
    if lut is not None:
        meta["lut"] = lut
    return fm, ssa, genome, meta


def write_pac(path, symbols: np.ndarray):
    """BWA-layout .pac: 4 bases per byte, base i at shift ((~i & 3) <<
    1), then one byte holding n % 4 (``nvbio_tpu/io/index_file.py``)."""
    symbols = np.asarray(symbols, dtype=np.uint8) & 3
    n = len(symbols)
    n_bytes = (n + 3) // 4
    padded = np.zeros(n_bytes * 4, dtype=np.uint8)
    padded[:n] = symbols
    shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
    pac = np.bitwise_or.reduce(padded.reshape(n_bytes, 4) << shifts,
                               axis=1).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(pac.tobytes())
        f.write(bytes([n % 4]))


def read_pac(path) -> np.ndarray:
    """A BWA-layout .pac back to uint8 symbols (the reference's
    ``read_pac``)."""
    data = np.frombuffer(open(path, "rb").read(), dtype=np.uint8)
    rem = int(data[-1])
    pac = data[:-1]
    shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
    syms = ((pac[:, None] >> shifts[None, :]) & 3).reshape(-1)
    n = (len(pac) - 1) * 4 + rem if rem else len(pac) * 4
    return syms[:n].astype(np.uint8)
