"""Traceback walks over the wavefront kernel's direction flags.

Port of ``nvbio_tpu/alignment/wavefront_walk.py``
(``walk_wavefront_dirs`` ``:23``, ``walk_wavefront_dirs_device`` ``:90``,
``compress_ops`` ``:180``) over the port's own flag layout, the banded
column sweep's (``ops/wavefront_dp.py``): (NB, S, T, 32) int32 words,
cell (r, j) in nibble i of word [p, s, l] with r = 256 p + 8 l + 1 + i
and s = j - jbase(p) + l.  The state machine is the JAX package's: from
(p_end, t_end), in state H the flag's H source emits M (diagonal step)
or enters E (D run, text gap) or F (I run, pattern gap), origin stops;
in E and F each step emits one op and the E-open / F-open bit returns to
H.  Cells outside the layout read as origin.  Op codes {1 M, 2 D, 3 I},
END->START order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.wavefront_dp import SWEEP_ROWS, SWEEP_RPL, sweep_jbase

#: lanes' steps between two checks whether every lane has stopped (one
#: host sync per check, not per step)
CHECK_EVERY = 256


def _flag_slot(r: int, j: int, band_w: int):
    """(strip, step, lane, nibble) of cell (r, j), r >= 1."""
    p, rem = divmod(r - 1, SWEEP_ROWS)
    lane, i = divmod(rem, SWEEP_RPL)
    return p, j - sweep_jbase(p, band_w) + lane, lane, i


def _row_tables(n_strips: int, n_steps: int, band_w: int, dev):
    """Per pattern row r (0 .. S * SWEEP_ROWS): the column whose word is
    at step 0 of the row's lane, its word index at step 0 in one
    alignment's flat words, and the row's nibble shift; stacked (3, rows).
    Row 0 lies outside the layout (its step-0 column is past any text)."""
    r = torch.arange(n_strips * SWEEP_ROWS + 1, device=dev)
    p = (r - 1).clamp(min=0) // SWEEP_ROWS
    lane = (r - 1).clamp(min=0) % SWEEP_ROWS // SWEEP_RPL
    jlo = sweep_jbase(p, band_w) - lane
    jlo[0] = 1 << 40
    word0 = p * (n_steps * 32) + lane
    shift = 4 * ((r - 1).clamp(min=0) % SWEEP_RPL)
    return torch.stack([jlo, word0, shift])


def walk_wavefront_dirs(dirs, band_w: int, p_end: int, t_end: int):
    """Trace one alignment from (p_end, t_end) back to its start on the
    host.  ``dirs``: (S, T, 32) flag words of ONE alignment.

    Returns (run_ops uint8 codes {1 M, 2 D, 3 I} in END->START order,
    run_lens int32, p_start, t_start)."""
    dirs = np.asarray(dirs)
    n_strips, n_steps = dirs.shape[:2]

    def flag(r, j):
        p, s, lane, i = _flag_slot(r, j, band_w)
        if not (p < n_strips and 0 <= s < n_steps):
            return 3  # outside the kernel's layout: stop
        return (int(dirs[p, s, lane]) >> (4 * i)) & 0xF

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


def walk_wavefront_dirs_device(dirs, p_end, t_end, *, band_w: int, lp: int,
                               lt: int):
    """Every lane's walk in lockstep on the flags' device.

    The JAX package's ``lax.while_loop`` walk: per step one flag gather
    per lane and the state machine of ``walk_wavefront_dirs`` (the same
    op streams), emitting per-step op codes into a bounded uint8 buffer;
    only that buffer needs to reach the host, where ``compress_ops``
    turns it into runs.  Whether any lane is still walking is checked
    every CHECK_EVERY steps; a step of a stopped lane changes nothing.
    A cell's word comes from per-row tables (``_row_tables``), so that a
    step costs few torch ops: the walk is bound by their launches.

    ``dirs``: (NB, S, T, 32) int32 flag words of patterns of width
    ``lp`` against texts of width ``lt``.  Returns (ops (NB, Lp + Lt + 2)
    uint8, n_ops (NB,), p_start (NB,), t_start (NB,)), int64 counts."""
    nb, n_strips, n_steps, _ = dirs.shape
    dev = dirs.device
    flat = dirs.reshape(nb, -1)
    tab = _row_tables(n_strips, n_steps, band_w, dev)
    sp = lp + lt + 2  # emissions <= p_end + t_end <= Lp + Lt
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
            jlo, word0, shift = tab[:, r]
            s = j - jlo
            sc = s.clamp(0, n_steps - 1)
            word = torch.gather(flat, 1, (word0 + sc * 32)[:, None])[:, 0]
            f = torch.where(sc == s, (word >> shift) & 0xF, 3)
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
