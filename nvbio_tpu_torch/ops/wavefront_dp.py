"""K5: wide-band banded Gotoh, score-only and with flags.

Port of ``nvbio_tpu/ops/wavefront_dp.py`` (``wavefront_score_pallas``
``:349``, ``wavefront_dirs_pallas`` ``:321``, both through
``_wavefront_call`` ``:372``).  The kernels are in
``csrc/wavefront_gotoh.cu`` (built by ``_build.py`` at first use).  The
formula score entry point has two tiers; the shape alone picks one:

- Lp <= BAND_MAX_LP (32 strips of 256 rows), at any band (every K5 call
  of ``sw_benchmark --long``: its ``gotoh_wide`` rows and ``wide_cigar``'s
  pass 1): the banded column sweep (``k5_band_score``).
  One block an alignment, warp p on the 256 pattern rows of strip p,
  lane l on 8 of them in registers, sweeping the text's columns of its
  rows' band one step behind lane l - 1; strip p + 1 reads strip p's last
  row from a ring in shared memory as it is written.
  ``wavefront_score.sweep_launches`` counts these calls.
- wider patterns: the diagonal kernel (``k5_wavefront_score``): one block
  per alignment, the anti-diagonal across its threads, every diagonal in
  a loop inside the block.

The flag entry point (``wavefront_dirs``, wide CIGAR's pass 3) takes the
same banded column sweep with flags (``k5_band_directions``) at any Lp:
every row up to Lp, each lane storing one 32-bit word of its 8 rows'
flags a step, so that a warp stores 128 contiguous bytes a step.
Where the batch leaves SMs idle (pass 3 calls it on 8 lanes) an
alignment's strips spread over a thread-block cluster (``dirs_plan``:
4 blocks of 4 strips at pass 3's Lp 4 000), the rings between blocks in
distributed shared memory; where the batch fills the SMs, or a block of
the cluster would need more than 32 strips, one block takes them all,
patterns of more than 32 strips in passes of 32 that hand their last row
on through a boundary row in device scratch.  ``wavefront_dirs.
sweep_launches`` counts these calls (all of them).  What bounds it: a
strip's step latency (8 rows of three dependent operations) on the
critical path of ~Lp + 2 w steps plus ~300 a strip handoff; on one block
an alignment, its warps' issue of ~8 flag instructions a cell beside the
score's.

K5 returns raw twin values (``wavefront_dp.py:33-40``): its plain version
is ``alignment/batched.py`` ``banded_score_batch(twin=True)``, and the
plain version of its flags is the twin's flags
(``banded_directions_batch``) laid out as the kernel writes them
(``twin_flags_to_sweep``).  The wrappers take the plain versions for
tensors on the CPU, and only then; for CUDA tensors they launch the kernel
or raise.  ``wavefront_score.launches`` and ``wavefront_dirs.launches``
count the launches (the former of both tiers).

``wavefront_score`` passes a substitution-matrix scheme
(``alignment.blosum.MatrixScheme``, protein SW) to
``wavefront_score_matrix``: the kernel's matrix mode, whose plain version
is the twin's matrix gather (``_subst_scores``).  It has two tiers, both
in ``csrc/wavefront_gotoh.cu`` with the table staged in shared memory:

- band_w >= max(Lp, Lt), every call of ``alignment.extra.
  full_score_batch`` (``protein_sw``): the full-band tier
  (``k5_full_score_matrix``).  No band edge binds inside the text there,
  so the DP is the textbook full matrix: one warp an alignment, lane l
  holding ``FULL_RPL`` pattern rows in registers and sweeping the text's
  columns one step behind lane l - 1, the substitution from the table in
  shared memory, no block barrier.  Patterns longer than 32 * FULL_RPL
  rows take several passes through a boundary row in device scratch
  (``_full_scratch``: one row a warp of the persistent grid, so its size
  follows the warps in flight, not the batch).
- any narrower band: the diagonal kernel's matrix mode
  (``k5_wavefront_score_matrix``, one block an alignment).

``wavefront_score_matrix.launches`` counts every matrix-mode launch,
``wavefront_score_matrix.full_launches`` those of the full-band tier.
The shape alone picks the tier.  No tool walks a protein traceback, so
``wavefront_dirs`` refuses a matrix scheme.

Flag layout (the port's own, the sweep's; only
``alignment/wavefront_walk.py`` reads it).  dirs is (NB, S, T, 32)
int32 (the bits of 32-bit words), S = ceil(Lp / SWEEP_ROWS) strips and T
= SWEEP_ROWS + 2 w + 32 steps (``flag_shape``).  Word [b, p, s, l] holds
lane l's rows r0 .. r0 + 7, r0 = SWEEP_ROWS p + SWEEP_RPL l + 1, at
column j = jbase(p) + s - l, jbase(p) = max(0, SWEEP_ROWS p + 1 - w) - 1
(``sweep_jbase``), row r0 + i in nibble i.  The nibble is the twin's
encoding (bits 0-1 H source diag / E / F / origin, bit 2 E open, bit 3 F
open); cells outside the band, invalid cells (j < 0 or j > tlen) and
rows past Lp hold 3, as every word of a step the kernel does not
compute.
"""

from __future__ import annotations

import torch

from ..alignment.batched import (_is_matrix, _matrix_table,
                                 banded_directions_batch, banded_score_batch)
from ..alignment.types import AlignmentType, GotohScheme, gap_penalties
from . import _build, _launch

def _max_penalty(scheme) -> int:
    """The largest score step of a scheme: its largest |substitution|
    and its gap penalties."""
    if _is_matrix(scheme):
        subst = int(abs(scheme.matrix_np).max())
    else:
        subst = max(scheme.mismatch_max, scheme.n_penalty, abs(scheme.match))
    return max(subst, *gap_penalties(scheme))


#: flag bytes one call may allocate (``wavefront_dp.py:436``)
MAX_DIRS_BYTES = 6 << 30

#: pattern rows a lane of the full-band tier holds (``FB_RPL`` in
#: ``csrc/wavefront_gotoh.cu``); a pass sweeps 32 * FULL_RPL rows
FULL_RPL = 8

#: pattern rows a lane, and a strip (a warp), of the banded column-sweep
#: tiers (``BS_RPL``, ``BS_ROWS`` in ``csrc/wavefront_gotoh.cu``): the
#: flag layout's nibbles a word and rows a strip
SWEEP_RPL = 8
SWEEP_ROWS = 32 * SWEEP_RPL

#: the formula score entry point's banded tier (``k5_band_score``) takes
#: patterns of at most 32 strips of 256 rows (a warp a strip, one block
#: of at most 1 024 threads), at any band: it beat the diagonal kernel at
#: every band measured, 16 to 2 000 (PERF.md, PR 18)
BAND_MAX_LP = 32 * 256


def kmul(band_w: int) -> int:
    """The sink key multiplier of the JAX kernel (``wavefront_dp.py:310``):
    key = r * KMUL + k."""
    return 1 << max(2 * band_w + 2, 2).bit_length()


def check_wavefront(lp: int, lt: int, band_w: int, scheme) -> None:
    """The JAX kernel's two asserts, as ValueError: the sink key range
    (``wavefront_dp.py:311-313``) and the score range (``:384-385``),
    the latter over a matrix scheme's largest |substitution|.  The
    reference's XLA twin, which scores a matrix scheme there, has
    neither guard."""
    if band_w < 0 or lp < 1:
        raise ValueError(f"band_w={band_w}, Lp={lp}: need band_w >= 0 and "
                         "Lp >= 1")
    km = kmul(band_w)
    if (lp + 2) * km >= 1 << 31:
        raise ValueError(
            f"pattern too long for the sink key encoding at band_w={band_w}"
            f" (Lp={lp}, Lt={lt}, KMUL={km})")
    if (lp + lt + 2 * band_w + 4) * _max_penalty(scheme) >= 1 << 29:
        raise ValueError("score range too wide for the int32 body")


def flag_shape(lp: int, band_w: int) -> tuple[int, int]:
    """(S, T) of the flag layout (module docstring): strips of SWEEP_ROWS
    pattern rows, and steps a strip."""
    return -(-lp // SWEEP_ROWS), SWEEP_ROWS + 2 * band_w + 32


def sweep_jbase(strip, band_w: int):
    """The column lane 0 of ``strip`` (an int or an int64 tensor) works
    at step 0: ``jbase`` of ``bs_strip``."""
    if isinstance(strip, torch.Tensor):
        return (strip * SWEEP_ROWS + 1 - band_w).clamp(min=0) - 1
    return max(0, strip * SWEEP_ROWS + 1 - band_w) - 1


def twin_flags_to_sweep(dirs, band_w: int) -> torch.Tensor:
    """The twin's flags (NB, Lp, 2w+1), row r at index r - 1 and band
    column k = j - r + w, in the kernel's sweep layout (NB, S, T, 32)
    int32: nibble i of word [b, p, s, l] is cell (r, j) = (SWEEP_ROWS p +
    SWEEP_RPL l + 1 + i, sweep_jbase(p) + s - l), 3 outside the twin's rows
    and band.  Cells of the twin's rows that are invalid already hold 3
    there."""
    nb, lp, band = dirs.shape
    n_strips, n_steps = flag_shape(lp, band_w)
    dev = dirs.device
    p = torch.arange(n_strips, device=dev).view(-1, 1, 1)
    s = torch.arange(n_steps, device=dev).view(1, -1, 1)
    lane = torch.arange(32, device=dev).view(1, 1, -1)
    j = sweep_jbase(p, band_w) + s - lane
    flat = dirs.reshape(nb, lp * band)
    words = torch.zeros((nb, n_strips, n_steps, 32), dtype=torch.int64,
                        device=dev)
    for i in range(SWEEP_RPL):  # one nibble at a time: bounded memory
        r = p * SWEEP_ROWS + lane * SWEEP_RPL + 1 + i
        k = j - r + band_w
        ok = (r <= lp) & (k >= 0) & (k < band)
        idx = ((r - 1).clamp(max=lp - 1) * band + k.clamp(0, band - 1))
        nib = flat[:, idx.reshape(-1)].reshape(words.shape).to(torch.int64)
        words |= torch.where(ok, nib, 3) << (4 * i)
    # the 32-bit words as int32 (torch has no uint32 arithmetic)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def wavefront_dirs_plain(patterns, plens, texts, tlens, quals=None, *,
                         scheme: GotohScheme, atype: AlignmentType,
                         band_w: int):
    """K5-with-flags' plain version: the twin's score and flags, the flags
    in the kernel's layout."""
    res, dirs = banded_directions_batch(patterns, plens, texts, tlens, quals,
                                        scheme=scheme, atype=atype,
                                        band_w=band_w, twin=True)
    return res, twin_flags_to_sweep(dirs, band_w)


def _scratch(lib, nb: int, band_w: int, dev) -> torch.Tensor:
    """A block's DP state lives in shared memory up to the capacity the
    library reports, beyond it in this scratch (one slice per block)."""
    words = lib.k5_state_words(band_w)
    return torch.empty((nb if words else 1, max(words, 1)),
                       dtype=torch.int32, device=dev)


def _full_scratch(lib, nb: int, lp: int, band_w: int, atype,
                  dev) -> torch.Tensor:
    """The full-band tier's scratch: its alignment counter and a boundary
    row for each warp of the persistent grid (the library sizes it)."""
    with torch.cuda.device(dev):
        words = lib.k5_full_scratch_words(nb, lp, band_w, atype.value)
    if words < 0:
        raise RuntimeError("k5_full_scratch_words: CUDA error sizing the "
                           "full-band tier's grid")
    return torch.empty(words, dtype=torch.int32, device=dev)


def full_band(lp: int, lt: int, band_w: int) -> bool:
    """Whether a matrix-mode call of this shape takes the full-band tier:
    no band edge binds inside the text (band_w >= max(Lp, Lt))."""
    return band_w >= max(lp, lt)


def band_tier(lp: int) -> bool:
    """Whether a formula ``wavefront_score`` call with patterns of width
    ``lp`` takes the banded column-sweep tier on CUDA tensors."""
    return lp <= BAND_MAX_LP


def _launch_k5_matrix(patterns, plens, texts, tlens, scheme, atype, band_w):
    pats, _, pl, tl, out = _launch.stage_inputs(patterns, plens, tlens, None)
    tx = _launch.stage_texts(texts, pats.shape[0])
    nb, lp = pats.shape
    lt = tx.shape[1]
    dev = pats.device
    # the table is the twin's own; the C entry bounds K (MAX_MAT_K there)
    mat = _matrix_table(scheme, dev)
    k = mat.shape[0]
    if mat.dim() != 2 or mat.shape[1] != k:
        raise ValueError(f"substitution matrix {tuple(mat.shape)}: need "
                         "K x K")
    lib = _build.library()
    if full_band(lp, lt, band_w):
        name = "k5_full_score_matrix"
        scratch = _full_scratch(lib, nb, lp, band_w, atype, dev)
    else:
        name = "k5_wavefront_score_matrix"
        scratch = _scratch(lib, nb, band_w, dev)
    _launch.call(
        name, dev, pats.data_ptr(), pl.data_ptr(), tx.data_ptr(),
        tl.data_ptr(), nb, lp, lt, band_w, atype.value,
        *gap_penalties(scheme), mat.data_ptr(), k, scratch.data_ptr(),
        out.data_ptr())
    return _launch.result(out)


def dirs_plan(nb: int, lp: int, dev) -> tuple[int, int]:
    """(blocks an alignment, warps a block) of the flag tier's launch for
    ``nb`` alignments of width ``lp`` on CUDA device ``dev``: a cluster of
    blocks while the batch leaves SMs idle (pass 3's 8 lanes take 8 SMs
    an alignment) and a block of the cluster needs at most 32 strips,
    else one block taking the strips, in passes past 32."""
    import ctypes

    plan = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        rc = _build.library().k5_band_dirs_plan(nb, lp,
                                                ctypes.addressof(plan))
    if rc != 0:
        raise ValueError(f"K5's flag tier has no grid for nb={nb}, Lp={lp} "
                         f"(CUDA error {rc})")
    return plan[0], plan[1]


def _launch_k5(patterns, plens, texts, tlens, quals, scheme, atype, band_w,
               kernel):
    """Stage the inputs and launch one of K5's formula C entries by name:
    ``k5_band_score`` (the banded column sweep, Lp <= BAND_MAX_LP),
    ``k5_wavefront_score`` (the diagonal kernel) or ``k5_band_directions``
    (the sweep with flags, any Lp, on ``dirs_plan``'s grid; returns
    (result, dirs)).  Counts nothing: the public wrappers pick the entry
    and count their launches."""
    pats, qual, pl, tl, out = _launch.stage_inputs(patterns, plens, tlens,
                                                   quals)
    tx = _launch.stage_texts(texts, pats.shape[0])
    nb, lp = pats.shape
    lt = tx.shape[1]
    dev = pats.device
    head = (pats.data_ptr(), qual.data_ptr(), pl.data_ptr(), tx.data_ptr(),
            tl.data_ptr(), nb, lp, lt, band_w,
            *_launch.scheme_args(scheme, atype))
    if kernel == "k5_band_score":
        _launch.call(kernel, dev, *head, out.data_ptr())
        return _launch.result(out)
    lib = _build.library()
    if kernel == "k5_band_directions":
        n_strips, n_steps = flag_shape(lp, band_w)
        nbytes = nb * n_strips * n_steps * 32 * 4
        if nbytes > MAX_DIRS_BYTES:
            raise ValueError(
                f"wavefront flags would need {nbytes / 2**30:.1f} GiB; walk "
                "fewer alignments per call")
        # the boundary rows between passes of 32 strips (Lp > 8 192)
        words = lib.k5_band_dirs_scratch_words(nb, lp, band_w)
        scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
        # every word is written by the kernel
        dirs = torch.empty((nb, n_strips, n_steps, 32), dtype=torch.int32,
                           device=dev)
        _launch.call(kernel, dev, *head, scratch.data_ptr(),
                     out.data_ptr(), dirs.data_ptr())
        return _launch.result(out), dirs
    if kernel != "k5_wavefront_score":
        raise ValueError(f"no K5 formula entry {kernel!r}")
    scratch = _scratch(lib, nb, band_w, dev)
    _launch.call(kernel, dev, *head, scratch.data_ptr(), out.data_ptr())
    return _launch.result(out)


def wavefront_score(patterns, plens, texts, tlens, quals=None, *,
                    scheme: GotohScheme, atype: AlignmentType, band_w: int):
    """K5 score-only: wide-band banded Gotoh score + sink, raw twin values.
    On CUDA tensors ``band_tier(Lp)`` shapes take the banded column
    sweep, wider patterns the diagonal kernel (module docstring).

    patterns (NB, Lp) symbols (0..3, N >= 4); texts (NB, Lt); plens,
    tlens (NB,); quals (NB, Lp) or None (= 40).  Returns dict of (NB,)
    int32 ``score``, ``p_end``, ``t_end``.  With a matrix ``scheme``
    the symbols are the matrix's (protein 0..21) and quals are ignored,
    as in the twin."""
    if _is_matrix(scheme):
        return wavefront_score_matrix(patterns, plens, texts, tlens,
                                      scheme=scheme, atype=atype,
                                      band_w=band_w)
    check_wavefront(patterns.shape[1], texts.shape[1], band_w, scheme)
    if _launch.on_cpu(patterns, plens, texts, tlens, quals):
        return banded_score_batch(patterns, plens, texts, tlens, quals,
                                  scheme=scheme, atype=atype, band_w=band_w,
                                  twin=True)
    sweep = band_tier(patterns.shape[1])
    res = _launch_k5(patterns, plens, texts, tlens, quals, scheme, atype,
                     band_w, "k5_band_score" if sweep else
                     "k5_wavefront_score")
    wavefront_score.launches += 1
    wavefront_score.sweep_launches += sweep
    return res


def wavefront_score_matrix(patterns, plens, texts, tlens, *, scheme,
                           atype: AlignmentType, band_w: int):
    """K5's matrix mode: ``wavefront_score`` with the substitution from
    ``scheme.matrix_np`` (a ``MatrixScheme``), table[clip(p), clip(t)]
    over symbols clipped to [0, K - 1], no quality term.  The plain
    version is the twin's matrix gather (``banded_score_batch(twin=True)``
    with the same scheme).  On CUDA tensors band_w >= max(Lp, Lt) takes
    the full-band tier, any narrower band the diagonal kernel (module
    docstring)."""
    check_wavefront(patterns.shape[1], texts.shape[1], band_w, scheme)
    if _launch.on_cpu(patterns, plens, texts, tlens):
        return banded_score_batch(patterns, plens, texts, tlens, None,
                                  scheme=scheme, atype=atype, band_w=band_w,
                                  twin=True)
    res = _launch_k5_matrix(patterns, plens, texts, tlens, scheme, atype,
                            band_w)
    wavefront_score_matrix.launches += 1
    wavefront_score_matrix.full_launches += full_band(
        patterns.shape[1], texts.shape[1], band_w)
    return res


def wavefront_dirs(patterns, plens, texts, tlens, quals=None, *,
                   scheme: GotohScheme, atype: AlignmentType, band_w: int):
    """K5 with flags: ``wavefront_score``'s outputs plus one 4-bit flag
    per band cell in the sweep layout (module docstring).  On CUDA
    tensors every call takes the banded column sweep with flags
    (``k5_band_directions``), at any Lp.

    Returns (result dict, dirs (NB, S, T, 32) int32 with (S, T) =
    ``flag_shape(Lp, band_w)``).  A matrix scheme raises ValueError
    (module docstring).
    The result equals ``wavefront_score``'s, except on a lane with plen
    > Lp, where it is the plain version's (score NEG_INF, ends 0 outside
    LOCAL)."""
    if _is_matrix(scheme):
        raise ValueError("K5's flag entry point takes no substitution "
                         "matrix: score a matrix scheme with "
                         "wavefront_score")
    check_wavefront(patterns.shape[1], texts.shape[1], band_w, scheme)
    if _launch.on_cpu(patterns, plens, texts, tlens, quals):
        return wavefront_dirs_plain(patterns, plens, texts, tlens, quals,
                                    scheme=scheme, atype=atype,
                                    band_w=band_w)
    res = _launch_k5(patterns, plens, texts, tlens, quals, scheme, atype,
                     band_w, "k5_band_directions")
    wavefront_dirs.launches += 1
    wavefront_dirs.sweep_launches += 1
    return res


wavefront_score.launches = 0
wavefront_score.sweep_launches = 0
wavefront_score_matrix.launches = 0
wavefront_score_matrix.full_launches = 0
wavefront_dirs.launches = 0
wavefront_dirs.sweep_launches = 0
