"""Run-compressed traceback walk over direction-flag matrices.

Port of ``nvbio_tpu/alignment/walk.py:runjump_walk``.  The trace
automaton's moves are runs — M-runs straight down a band column,
D-runs (E state) left along a row, I-runs (F state) down an
anti-diagonal — so every cell's whole run (length + landing cell) is
precomputed with three scans over the flag matrix, and the walk jumps
one CIGAR run per round instead of one cell.

Flag encoding (banded_directions_*): bits 0-1 H source (0 diag, 1 E,
2 F, 3 origin), bit 2 E open, bit 3 F open; cell (i, k) of the walk
reads flag row i - 1.
"""

from __future__ import annotations

import torch

#: BIG: a run that never closes (the reference's I-run cap)
_BIG = 1 << 12
#: flag cells per block of lanes whose run descriptors are built at once
#: (bounds the scans' temporaries: ~50 bytes a cell)
_BLOCK_CELLS = 1 << 23


def _anti_diagonal_gaps(bit3):
    """G[r, k]: steps up-right along the anti-diagonal (r - t, k + t) to
    the nearest F-open bit, capped at _BIG; _BIG when row 0 or the band
    edge comes first.  Pointer doubling: ceil(log2(min(ROWS, STRIDE)))
    shifted passes, each doubling the reach, instead of a loop over
    rows.  bit3 (R, ROWS, STRIDE) bool -> int32."""
    _, rows, stride = bit3.shape
    inf = torch.iinfo(torch.int32).max
    # first hit within [0, step) steps; inf where none
    g = torch.where(bit3, 0, inf).to(torch.int32)
    step = 1
    while step < min(rows, stride):
        back = torch.full_like(g, inf)
        back[:, step:, :stride - step] = g[:, :-step, step:]
        g = torch.where(g < inf, g,
                        torch.where(back < inf, back + step, inf))
        step *= 2
    return g.clamp(max=_BIG)


def _descriptors(F):
    """One packed int32 descriptor per cell of a (R, ROWS, STRIDE) uint8
    flag block: op(2) | term(1) | len(29); the landing cell is
    arithmetic in (op, len)."""
    _, rows, stride = F.shape
    dev = F.device
    f2 = F & 3
    is_m, is_e, is_f = f2 == 0, f2 == 1, f2 == 2
    # M-runs: NZ[r, k] = last row <= r with a non-diag flag (-1 if none)
    ridx = torch.arange(rows, dtype=torch.int32, device=dev)[None, :, None]
    nz = torch.cummax(torch.where(is_m, -1, ridx), dim=1).values
    # D-runs: EE[r, k] = last column <= k with the E-open bit (-1 if none)
    cidx = torch.arange(stride, dtype=torch.int32, device=dev)[None, None, :]
    ee = torch.cummax(torch.where((F & 4) != 0, cidx, -1), dim=2).values
    # I-runs: G[r, k] = steps up-right along the anti-diagonal to the
    # nearest F-open bit
    g = _anti_diagonal_gaps((F & 8) != 0)
    ln = torch.where(is_m, ridx - nz, torch.where(is_e, cidx - ee + 1, g + 1))
    del nz
    op = torch.where(is_m, 1, torch.where(is_e, 2, torch.where(is_f, 3, 0)))
    # terminal: origin, or a garbage lane whose run never closes or lands
    # outside the band (genuine traces end at the origin or row 0)
    term = ((f2 == 3) | (is_e & (ee <= 0)) | (is_f & (g >= _BIG))
            | (is_f & (cidx + g + 1 >= stride)))
    del ee, g
    return (op.to(torch.int32) | (term.to(torch.int32) << 2)
            | (ln.clamp(0, (1 << 29) - 1) << 3))


def runjump_walk(dirs_flat, STRIDE: int, i0, k0, active=None,
                 max_runs: int | None = None):
    """Run-level traceback walk from cells (i0, k0).

    dirs_flat (R, ROWS * STRIDE) uint8.  Returns (p_start, k_final,
    run_ops (R, MAXR) uint8 codes {0 none, 1 M, 2 D, 3 I}, run_lens (R,
    MAXR) int32), runs in end->start order.  ``max_runs`` caps MAXR
    (both the round count and the outputs); ``active`` (R,) bool lanes
    to walk (None = all).

    The run descriptors are int32 and built for blocks of lanes at a
    time, so a batch of long patterns (R = 1024, ROWS = 2016, STRIDE =
    127) holds 4 bytes per cell beside its flags, not ten int64 scans."""
    R, LPS = dirs_flat.shape
    ROWS = LPS // STRIDE
    dev = dirs_flat.device
    F = dirs_flat.reshape(R, ROWS, STRIDE)
    desc = torch.empty((R, LPS), dtype=torch.int32, device=dev)
    lanes = max(1, _BLOCK_CELLS // max(LPS, 1))
    for r0 in range(0, R, lanes):
        desc[r0:r0 + lanes] = _descriptors(F[r0:r0 + lanes]).reshape(-1, LPS)

    MAXR = 2 * ROWS + STRIDE + 4
    if max_runs is not None:
        MAXR = min(MAXR, max_runs)
    i = i0.to(torch.int64)
    k = k0.to(torch.int64)
    done = (torch.zeros(R, dtype=torch.bool, device=dev) if active is None
            else ~active.to(torch.bool))
    rops = torch.zeros((R, MAXR), dtype=torch.uint8, device=dev)
    rlens = torch.zeros((R, MAXR), dtype=torch.int32, device=dev)
    t = 0
    while t < MAXR and not bool(done.all()):
        done = done | (i <= 0) | (k < 0) | (k >= STRIDE)
        idx = ((i - 1) * STRIDE + k).clamp(0, LPS - 1)
        d = torch.gather(desc, 1, idx[:, None])[:, 0].to(torch.int64)
        stop = ((d >> 2) & 1) == 1
        act = ~done & ~stop
        done = done | stop
        op_t = d & 3
        ln_t = d >> 3
        rops[:, t] = torch.where(act, op_t, 0).to(torch.uint8)
        rlens[:, t] = torch.where(act, ln_t, 0).to(torch.int32)
        i = torch.where(act & (op_t != 2), i - ln_t, i)
        k = torch.where(act, k + torch.where(
            op_t == 3, ln_t, torch.where(op_t == 2, -ln_t, 0)), k)
        t += 1
    return i, k, rops, rlens
