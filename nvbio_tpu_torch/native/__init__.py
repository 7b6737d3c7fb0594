"""Native host layer: lazy-built C++ fast paths with Python fallbacks.

``lib()`` compiles ``fastio.cpp`` with g++ on first use (cached .so in
``_build/`` beside this file) and returns the ctypes handle, or None
when no toolchain is available — callers must fall back to the
pure-Python implementations.

A copy of ``nvbio_tpu/native/__init__.py`` (and its C++ sources) for the
PyTorch port: the libraries build from this package's own sources into
its own ``_build/`` directory, written to a temporary name and renamed,
so that concurrent first uses never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "_build")
_SO = os.path.join(_BUILD_DIR, "_fastio.so")
_SRC = os.path.join(_DIR, "fastio.cpp")
_lock = threading.Lock()
_lib = None
_tried = False
_SAIS_SO = os.path.join(_BUILD_DIR, "_sais.so")
_SAIS_SRC = os.path.join(_DIR, "sais.cpp")
_sais_lib = None
_sais_tried = False


def _build(src, so, *extra):
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp, *extra],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def lib():
    """Return the ctypes library handle (building if needed) or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            L = _build(_SRC, _SO, "-lz")
            L.fastq_parse.restype = ctypes.c_long
            L.fastq_count.restype = ctypes.c_long
            L.bgzf_compress.restype = ctypes.c_long
            _lib = L
        except Exception:
            _lib = None
        return _lib


def _sais_resolve(L):
    L.sais_u8.restype = ctypes.c_long
    L.sais_u8_i32.restype = ctypes.c_long
    L.sais_bwt.restype = ctypes.c_long
    L.kmer_hist.restype = ctypes.c_long
    L.fm_bwt_occ_i32.restype = ctypes.c_long
    L.fm_bwt_occ_i64.restype = ctypes.c_long
    L.ssa_build_i32.restype = ctypes.c_long
    L.ssa_build_i64.restype = ctypes.c_long
    return L


def sais_lib():
    """ctypes handle for the SA-IS library, or None."""
    global _sais_lib, _sais_tried
    with _lock:
        if _sais_lib is not None or _sais_tried:
            return _sais_lib
        _sais_tried = True
        try:
            _sais_lib = _sais_resolve(_build(_SAIS_SRC, _SAIS_SO))
        except AttributeError:
            # A stale _sais.so (e.g. an archive extraction that kept
            # source mtimes newer than the .so it shipped) can lack the
            # newer symbols; silently losing the WHOLE native lib would
            # degrade gigabase builds to the Python fallback.  Rebuild
            # once from source before giving up.
            try:
                os.remove(_SAIS_SO)
                _sais_lib = _sais_resolve(_build(_SAIS_SRC, _SAIS_SO))
            except Exception:
                import warnings
                warnings.warn(
                    "nvbio_tpu_torch.native: _sais.so is stale/incomplete and "
                    "rebuild failed; falling back to Python index build")
                _sais_lib = None
        except Exception:
            _sais_lib = None
        return _sais_lib


def sais_native(text: np.ndarray):
    """Suffix array of uint8 `text` via native SA-IS; None if no lib.

    Sentinel-smallest convention, matching sufsort.suffix_array.
    """
    L = sais_lib()
    if L is None:
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(t)
    if n + 1 < (1 << 31):
        # int32 end-to-end: half the memory traffic, no conversion pass
        sa = np.empty(n, dtype=np.int32)
        r = L.sais_u8_i32(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.c_long(n),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    else:
        sa = np.empty(n, dtype=np.int64)
        r = L.sais_u8(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.c_long(n),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        )
    if r != 0:
        raise RuntimeError("sais_u8 failed")
    return sa


def fm_bwt_occ_native(text: np.ndarray, sa: np.ndarray):
    """Fused BWT + 2-bit word packing + blocked occ tables in one C++
    pass over the suffix array (layout of fmindex/build.py: BLOCK=128,
    WORDS=8).  Returns (bwt_words (n_blocks, 8) uint32, occ_abs
    (n_blocks, 4) int32, occ_sub (n_blocks, 8, 4) int8, primary int)
    or None if the native lib is unavailable."""
    L = sais_lib()
    if L is None:
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(t)
    if n == 0:
        return None
    # sais.cpp hardcodes the fmindex/build.py block geometry; break
    # loudly (not with a silently mis-laid-out array) if it drifts.
    from ..fmindex import build as _fb
    if _fb.BLOCK != 128 or _fb.WORDS != 8:
        raise RuntimeError(
            "native fm_bwt_occ assumes BLOCK=128/WORDS=8 but "
            f"fmindex.build has BLOCK={_fb.BLOCK}/WORDS={_fb.WORDS}; "
            "update sais.cpp fm_bwt_occ_impl to match")
    n_blocks = (n + 1 + 127) // 128 + 1
    bwt_words = np.empty((n_blocks, 8), dtype=np.uint32)
    occ_abs = np.empty((n_blocks, 4), dtype=np.int32)
    occ_sub = np.empty((n_blocks, 8, 4), dtype=np.int8)
    primary = ctypes.c_longlong(-1)
    c = ctypes
    if sa.dtype == np.int32:
        s = np.ascontiguousarray(sa, dtype=np.int32)
        fn, ptr = L.fm_bwt_occ_i32, c.POINTER(c.c_int32)
    else:
        s = np.ascontiguousarray(sa, dtype=np.int64)
        fn, ptr = L.fm_bwt_occ_i64, c.POINTER(c.c_int64)
    r = fn(
        t.ctypes.data_as(c.POINTER(c.c_ubyte)), c.c_long(n),
        s.ctypes.data_as(ptr),
        bwt_words.ctypes.data_as(c.POINTER(c.c_uint32)),
        occ_abs.ctypes.data_as(c.POINTER(c.c_int32)),
        occ_sub.ctypes.data_as(c.POINTER(c.c_byte)),
        c.byref(primary),
    )
    if r != 0:
        return None
    return bwt_words, occ_abs, occ_sub, int(primary.value)


def ssa_build_native(sa: np.ndarray, n: int, k: int, thresh: int,
                     n_words: int):
    """Sampled-SA mark bitmap + per-word rank prefix + sampled values
    in one C++ pass (layout of fmindex/build.py build_fm_arrays).
    Returns (mark_words uint32 (n_words,), mark_abs int32, vals int32)
    or None if the native lib is unavailable."""
    L = sais_lib()
    if L is None:
        return None
    c = ctypes
    mark_words = np.empty(n_words, dtype=np.uint32)
    mark_abs = np.empty(n_words, dtype=np.int32)
    cap = thresh * ((n + 1) // k + 2)
    vals = np.empty(cap, dtype=np.int32)
    if sa.dtype == np.int32:
        s = np.ascontiguousarray(sa, dtype=np.int32)
        fn, ptr = L.ssa_build_i32, c.POINTER(c.c_int32)
    else:
        s = np.ascontiguousarray(sa, dtype=np.int64)
        fn, ptr = L.ssa_build_i64, c.POINTER(c.c_int64)
    nv = fn(
        s.ctypes.data_as(ptr), c.c_long(n), c.c_int(k),
        c.c_int(thresh), c.c_long(n_words),
        mark_words.ctypes.data_as(c.POINTER(c.c_uint32)),
        mark_abs.ctypes.data_as(c.POINTER(c.c_int32)),
        vals.ctypes.data_as(c.POINTER(c.c_int32)),
        c.c_long(cap),  # bound enforced inside C++ BEFORE any write
    )
    if nv < 0:
        return None
    return mark_words, mark_abs, vals[:nv].copy()


def kmer_hist_native(text: np.ndarray, k: int):
    """Histogram of k-mer suffix keys (key2 = packed_key*2 + is_full)
    over all suffixes of `text`, as (2 << 2k,) int64 — the multiset
    fmindex.build.build_kmer_lut cumsums into SA ranges.  None if the
    native lib is unavailable."""
    L = sais_lib()
    if L is None or not (1 <= k <= 15):
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    counts = np.zeros(2 << (2 * k), dtype=np.int64)
    r = L.kmer_hist(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_long(len(t)), ctypes.c_int(k),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    if r != 0:
        return None
    return counts


def sais_bwt_native(text: np.ndarray, sa: np.ndarray):
    """(bwt, primary) from text + suffix array via C++; None if no lib."""
    L = sais_lib()
    if L is None:
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    s = np.ascontiguousarray(sa, dtype=np.int64)
    n = len(t)
    bwt = np.empty(n + 1, dtype=np.uint8)
    primary = ctypes.c_longlong(-1)
    r = L.sais_bwt(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_long(n),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.byref(primary),
    )
    if r != 0:
        raise RuntimeError("sais_bwt failed")
    return bwt, int(primary.value)


def fastq_parse_native(buf: bytes, max_len: int):
    """Parse a FASTQ byte buffer with the C++ parser.

    Returns (names list, reads (R, max_len) int8, lens, quals) or None
    if the native library is unavailable."""
    L = lib()
    if L is None:
        return None
    n = len(buf)
    cap = int(L.fastq_count(buf, ctypes.c_long(n)))
    reads = np.full((cap, max_len), 7, dtype=np.int8)
    quals = np.zeros((cap, max_len), dtype=np.uint8)
    lens = np.zeros(cap, dtype=np.int32)
    names_cap = n  # names cannot exceed the input size
    names_blob = np.zeros(names_cap, dtype=np.uint8)
    name_offs = np.zeros(cap + 1, dtype=np.int64)
    r = L.fastq_parse(
        buf, ctypes.c_long(n), ctypes.c_long(max_len),
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
        quals.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        names_blob.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        ctypes.c_long(names_cap),
        name_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ctypes.c_long(cap),
    )
    if r < 0:
        raise ValueError("malformed FASTQ (native parser)")
    blob = names_blob.tobytes()
    names = [
        blob[name_offs[i] : name_offs[i + 1] - 1].decode()
        for i in range(r)
    ]
    return names, reads[:r], lens[:r], quals[:r]


def bgzf_compress_native(data: bytes, level: int = 6):
    """BGZF-compress with the C++ path; None if unavailable."""
    L = lib()
    if L is None:
        return None
    out = np.zeros(len(data) + (len(data) >> 8) + 4096, dtype=np.uint8)
    w = L.bgzf_compress(
        data, ctypes.c_long(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_long(len(out)), ctypes.c_int(level),
    )
    if w < 0:
        return None
    return out[:w].tobytes()


_TB_SO = os.path.join(_BUILD_DIR, "_traceback.so")
_TB_SRC = os.path.join(_DIR, "traceback.cpp")
_tb_lib = None
_tb_tried = False


def tb_lib():
    """ctypes handle for the traceback library, or None."""
    global _tb_lib, _tb_tried
    with _lock:
        if _tb_lib is not None or _tb_tried:
            return _tb_lib
        _tb_tried = True
        try:
            L = _build(_TB_SRC, _TB_SO)
            L.tb_batch.restype = ctypes.c_long
            L.ops_batch.restype = ctypes.c_long
            _tb_lib = L
        except Exception:
            _tb_lib = None
        return _tb_lib


def tb_batch_native(dirs, p_end, t_end, aligned, pats, plens, genome,
                    win_start, band_w: int, global_mode: bool):
    """Batch traceback + CIGAR/MD/NM via C++; None if lib unavailable.

    Mirrors alignment/cigar.py exactly (oracle-tested); returns
    (cigars list[str], mds list[str], nm, pos, ref_span arrays)."""
    L = tb_lib()
    if L is None:
        return None
    dirs = np.ascontiguousarray(dirs, dtype=np.uint8)
    R, Lp, BAND = dirs.shape
    p_end = np.ascontiguousarray(p_end, dtype=np.int32)
    t_end = np.ascontiguousarray(t_end, dtype=np.int32)
    aligned = np.ascontiguousarray(aligned, dtype=np.uint8)
    pats = np.ascontiguousarray(pats, dtype=np.uint8)
    plens = np.ascontiguousarray(plens, dtype=np.int32)
    genome = np.ascontiguousarray(genome, dtype=np.int8)
    win_start = np.ascontiguousarray(win_start, dtype=np.int64)
    cig_cap = int(R * (Lp * 8 + 32) + 64)
    md_cap = cig_cap
    cig_blob = np.zeros(cig_cap, dtype=np.uint8)
    md_blob = np.zeros(md_cap, dtype=np.uint8)
    cig_offs = np.zeros(R + 1, dtype=np.int64)
    md_offs = np.zeros(R + 1, dtype=np.int64)
    nm = np.zeros(R, dtype=np.int32)
    pos = np.zeros(R, dtype=np.int32)
    span = np.zeros(R, dtype=np.int32)
    c = ctypes
    r = L.tb_batch(
        dirs.ctypes.data_as(c.POINTER(c.c_ubyte)),
        c.c_long(R), c.c_long(Lp), c.c_long(BAND),
        p_end.ctypes.data_as(c.POINTER(c.c_int)),
        t_end.ctypes.data_as(c.POINTER(c.c_int)),
        aligned.ctypes.data_as(c.POINTER(c.c_ubyte)),
        pats.ctypes.data_as(c.POINTER(c.c_ubyte)),
        plens.ctypes.data_as(c.POINTER(c.c_int)),
        genome.ctypes.data_as(c.POINTER(c.c_byte)),
        c.c_longlong(len(genome)),
        win_start.ctypes.data_as(c.POINTER(c.c_longlong)),
        c.c_int(band_w), c.c_int(1 if global_mode else 0),
        cig_blob.ctypes.data_as(c.POINTER(c.c_char)), c.c_long(cig_cap),
        cig_offs.ctypes.data_as(c.POINTER(c.c_longlong)),
        md_blob.ctypes.data_as(c.POINTER(c.c_char)), c.c_long(md_cap),
        md_offs.ctypes.data_as(c.POINTER(c.c_longlong)),
        nm.ctypes.data_as(c.POINTER(c.c_int)),
        pos.ctypes.data_as(c.POINTER(c.c_int)),
        span.ctypes.data_as(c.POINTER(c.c_int)),
    )
    if r != 0:
        raise RuntimeError(f"tb_batch failed: {r}")
    cb = cig_blob.tobytes()
    mb = md_blob.tobytes()
    cigars = [cb[cig_offs[i]:cig_offs[i + 1]].decode() for i in range(R)]
    mds = [mb[md_offs[i]:md_offs[i + 1]].decode() for i in range(R)]
    return cigars, mds, nm, pos, span


def ops_batch_native(ops, p_start, t_start, aligned, pats, plens,
                     genome, win_start, global_mode: bool):
    """CIGAR/MD/NM from device-walked 2-bit op streams via C++; None if
    the lib is unavailable.  Returns (cigars, mds, nm, pos, span)."""
    L = tb_lib()
    if L is None:
        return None
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    R, SP = ops.shape
    p_start = np.ascontiguousarray(p_start, dtype=np.int32)
    t_start = np.ascontiguousarray(t_start, dtype=np.int32)
    aligned = np.ascontiguousarray(aligned, dtype=np.uint8)
    pats = np.ascontiguousarray(pats, dtype=np.uint8)
    Lp = pats.shape[1]
    plens = np.ascontiguousarray(plens, dtype=np.int32)
    genome = np.ascontiguousarray(genome, dtype=np.int8)
    win_start = np.ascontiguousarray(win_start, dtype=np.int64)
    cig_cap = int(R * (SP * 16 + 32) + 64)
    md_cap = cig_cap
    cig_blob = np.zeros(cig_cap, dtype=np.uint8)
    md_blob = np.zeros(md_cap, dtype=np.uint8)
    cig_offs = np.zeros(R + 1, dtype=np.int64)
    md_offs = np.zeros(R + 1, dtype=np.int64)
    nm = np.zeros(R, dtype=np.int32)
    pos = np.zeros(R, dtype=np.int64)
    span = np.zeros(R, dtype=np.int32)
    c = ctypes
    r = L.ops_batch(
        ops.ctypes.data_as(c.POINTER(c.c_ubyte)),
        c.c_long(R), c.c_long(SP),
        p_start.ctypes.data_as(c.POINTER(c.c_int)),
        t_start.ctypes.data_as(c.POINTER(c.c_int)),
        aligned.ctypes.data_as(c.POINTER(c.c_ubyte)),
        pats.ctypes.data_as(c.POINTER(c.c_ubyte)),
        plens.ctypes.data_as(c.POINTER(c.c_int)),
        c.c_long(Lp),
        genome.ctypes.data_as(c.POINTER(c.c_byte)),
        win_start.ctypes.data_as(c.POINTER(c.c_longlong)),
        c.c_int(1 if global_mode else 0),
        cig_blob.ctypes.data_as(c.POINTER(c.c_char)), c.c_long(cig_cap),
        cig_offs.ctypes.data_as(c.POINTER(c.c_longlong)),
        md_blob.ctypes.data_as(c.POINTER(c.c_char)), c.c_long(md_cap),
        md_offs.ctypes.data_as(c.POINTER(c.c_longlong)),
        nm.ctypes.data_as(c.POINTER(c.c_int)),
        pos.ctypes.data_as(c.POINTER(c.c_longlong)),
        span.ctypes.data_as(c.POINTER(c.c_int)),
    )
    if r != 0:
        raise RuntimeError(f"ops_batch failed: {r}")
    cb = cig_blob.tobytes()
    mb = md_blob.tobytes()
    cigars = [cb[cig_offs[i]:cig_offs[i + 1]].decode() for i in range(R)]
    mds = [mb[md_offs[i]:md_offs[i + 1]].decode() for i in range(R)]
    return cigars, mds, nm, pos, span
