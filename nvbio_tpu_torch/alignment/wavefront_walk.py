"""Traceback walks over the wavefront kernel's direction flags.

Port of ``nvbio_tpu/alignment/wavefront_walk.py``
(``walk_wavefront_dirs`` ``:23``, ``walk_wavefront_dirs_device`` ``:90``,
``compress_ops`` ``:180``) over the port's own flag layout
(``ops/wavefront_dp.py``: (NB, D, ceil((w + 1) / 2)) uint8, diagonal d =
r + j, slot q = r - ceil((d - w) / 2), two slots per byte).  The state
machine is the JAX package's: from (p_end, t_end), in state H the flag's
H source emits M (diagonal step) or enters E (D run, text gap) or F (I
run, pattern gap), origin stops; in E and F each step emits one op and
the E-open / F-open bit returns to H.  Cells outside the layout read as
origin.  Op codes {1 M, 2 D, 3 I}, END->START order.
"""

from __future__ import annotations

import numpy as np
import torch

#: lanes' steps between two checks whether every lane has stopped (one
#: host sync per check, not per step)
CHECK_EVERY = 256


def _flag_index(r, j, band_w: int):
    """(diagonal, slot) of cell (r, j)."""
    d = r + j
    return d, r + (band_w - d) // 2


def walk_wavefront_dirs(dirs, band_w: int, p_end: int, t_end: int):
    """Trace one alignment from (p_end, t_end) back to its start on the
    host.  ``dirs``: (D, DB) uint8 flags of ONE alignment.

    Returns (run_ops uint8 codes {1 M, 2 D, 3 I} in END->START order,
    run_lens int32, p_start, t_start)."""
    dirs = np.asarray(dirs)
    ndiag = dirs.shape[0]

    def flag(r, j):
        d, q = _flag_index(r, j, band_w)
        if not (0 <= d < ndiag and 0 <= q <= band_w):
            return 3  # outside the kernel's layout: stop
        return (int(dirs[d, q >> 1]) >> (4 * (q & 1))) & 0xF

    r, j = int(p_end), int(t_end)
    ops: list[list[int]] = []  # [code, len] runs, end->start

    def emit(code):
        if ops and ops[-1][0] == code:
            ops[-1][1] += 1
        else:
            ops.append([code, 1])

    state = 0  # 0 = H, 1 = E (text gap, D), 2 = F (pattern gap, I)
    guard = 2 * (r + j) + 8
    while r > 0 and guard > 0:
        guard -= 1
        f = flag(r, j)
        if state == 0:
            src = f & 3
            if src == 3:
                break
            if src == 0:
                emit(1)  # M
                r -= 1
                j -= 1
            elif src == 1:
                state = 1
            else:
                state = 2
        elif state == 1:
            emit(2)  # D consumes text column j
            j -= 1
            if (f >> 2) & 1:
                state = 0
        else:
            emit(3)  # I consumes pattern row r
            r -= 1
            if (f >> 3) & 1:
                state = 0
    run_ops = np.array([o for o, _l in ops], np.uint8)
    run_lens = np.array([l for _o, l in ops], np.int32)
    return run_ops, run_lens, r, j


def walk_wavefront_dirs_device(dirs, p_end, t_end, *, band_w: int):
    """Every lane's walk in lockstep on the flags' device.

    The JAX package's ``lax.while_loop`` walk: per step one flag gather
    per lane and the state machine of ``walk_wavefront_dirs`` (the same
    op streams), emitting per-step op codes into a bounded uint8 buffer;
    only that buffer needs to reach the host, where ``compress_ops``
    turns it into runs.  Whether any lane is still walking is checked
    every CHECK_EVERY steps; a step of a stopped lane changes nothing.

    ``dirs``: (NB, D, DB) uint8.  Returns (ops (NB, D + 1) uint8,
    n_ops (NB,), p_start (NB,), t_start (NB,)), int64 counts."""
    nb, ndiag, db = dirs.shape
    dev = dirs.device
    flat = dirs.reshape(nb, ndiag * db)
    sp = ndiag + 1  # emissions <= p_end + t_end <= Lp + Lt
    tmax = 2 * sp + 8  # H -> E/F turns consume no cell
    r = p_end.to(torch.int64).clone()
    j = t_end.to(torch.int64).clone()
    st = torch.zeros(nb, dtype=torch.int64, device=dev)
    n = torch.zeros(nb, dtype=torch.int64, device=dev)
    stopped = torch.zeros(nb, dtype=torch.bool, device=dev)
    ops = torch.zeros((nb, sp + 1), dtype=torch.uint8, device=dev)
    t = 0
    while t < tmax:
        for _ in range(min(CHECK_EVERY, tmax - t)):
            d, q = _flag_index(r, j, band_w)
            inb = (d >= 0) & (d < ndiag) & (q >= 0) & (q <= band_w)
            idx = (d * db + (q >> 1)).clamp(0, ndiag * db - 1)
            byte = torch.gather(flat, 1, idx[:, None])[:, 0].to(torch.int64)
            f = torch.where(inb, (byte >> (4 * (q & 1))) & 0xF, 3)
            active = ~stopped & (r > 0)
            src = f & 3
            is_h = st == 0
            do_m = active & is_h & (src == 0)
            in_e = active & (st == 1)
            in_f = active & (st == 2)
            code = torch.where(do_m, 1, torch.where(in_e, 2,
                                                    torch.where(in_f, 3, 0)))
            emit = code > 0
            ops.scatter_(1, torch.where(emit, n, sp)[:, None],
                         code.to(torch.uint8)[:, None])
            n = n + emit
            r = r - (do_m | in_f).to(torch.int64)
            j = j - (do_m | in_e).to(torch.int64)
            st = torch.where(active & is_h & (src == 1), 1,
                             torch.where(active & is_h & (src == 2), 2, st))
            st = torch.where((in_e & (((f >> 2) & 1) == 1))
                             | (in_f & (((f >> 3) & 1) == 1)), 0, st)
            stopped = stopped | (active & is_h & (src == 3))
        t += CHECK_EVERY
        if not bool((~stopped & (r > 0)).any()):
            break
    return ops[:, :sp], n, r, j


def compress_ops(o: np.ndarray):
    """Per-step op codes (END->START) -> (run_ops, run_lens)."""
    o = np.asarray(o, np.uint8)
    if o.size == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int32)
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(o.astype(np.int16)) != 0) + 1])
    lens = np.diff(np.concatenate([starts, [o.size]]))
    return o[starts], lens.astype(np.int32)
