"""Build and load the hand-written CUDA kernels at first use.

``nvcc`` compiles each source in ``csrc/`` for ``sm_90a`` (one process
per source, all started together), then links the objects into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library lands in
``_build/`` beside this file (listed in ``.gitignore``), named by a hash
of the sources and the flags, so an edited source rebuilds and an
unchanged one loads the cached library (the hash covers the shared
header ``csrc/gotoh_common.cuh`` too).  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, "csrc", name)
           for name in ("banded_gotoh.cu", "long_gotoh.cu",
                        "wavefront_gotoh.cu", "myers.cu")]
HEADERS = [os.path.join(_DIR, "csrc", "gotoh_common.cuh")]
BUILD_DIR = os.path.join(_DIR, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: what the last build reported: seconds, the nvcc commands and their
#: ptxas output (registers, spills per kernel); None when loaded cached
build_info: dict | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# scheme... = match, mm_min, mm_max, n_penalty, eo, ee, fo, fe
_SCORE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_I] * 8 + [_P, _P]
_PACKED = ([_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I]
           + [_I] * 8 + [_P, _P])
_DIRS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_I] * 8 + [_P, _P, _P]
_SIGNATURES = {
    # pats, quals, plens, texts, tlens, nb, lp, lt, band_w, atype,
    # scheme..., out, stream
    "k1_banded_score": _SCORE,
    "k4_long_score": _SCORE,
    # pats, quals, plens, gwords, n_words, win_start, tlens, nb, lp,
    # band_w, atype, scheme..., out, stream
    "k3_banded_score_packed": _PACKED,
    "k4_long_score_packed": _PACKED,
    # as the score entry points, plus dirs before the stream
    "k2_banded_directions": _DIRS,
    "k4_long_directions": _DIRS,
    # as k4_long_score, plus the state scratch before out (and dirs after)
    "k5_wavefront_score": _SCORE[:-2] + [_P, _P, _P],
    "k5_wavefront_directions": _DIRS[:-3] + [_P, _P, _P, _P],
    # pats, plens, texts, tlens, nb, lp, lt, global, scratch, out, stream
    "k6_myers": [_P] * 4 + [_I] * 4 + [_P] * 3,
}
#: entry points that return a size, not a cudaError_t
_SIZES = {
    "k5_state_words": ([_I], ctypes.c_int),  # band_w
    "k6_scratch_words": ([_I, _I], ctypes.c_longlong),  # nb, lp
}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or NVCC): the CUDA kernels are "
        "built from nvbio_tpu_torch/ops/csrc at first use")


def _lib_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")


def _run(procs):
    """Wait for (cmd, Popen) pairs; raise with nvcc's output on failure.
    Returns the stderr of each (ptxas reports there)."""
    errs = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}\n{err}")
        errs.append(err)
    return errs


def build() -> str:
    """Compile the kernels if no library for these sources exists;
    returns the library's path.  Raises RuntimeError with nvcc's output
    when a compile fails."""
    global build_info
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    ptxas = _run(procs)
    tmp = f"{path}.{tag}"
    link = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
    _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, path)
    build_info = {"seconds": time.perf_counter() - t0,
                  "cmds": [cmd for cmd, _ in procs] + [link],
                  "ptxas": "\n".join(ptxas)}
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, (argtypes, restype) in _SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            lib.banded_gotoh_error_string.argtypes = [ctypes.c_int]
            lib.banded_gotoh_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.banded_gotoh_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
