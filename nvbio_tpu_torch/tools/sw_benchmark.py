"""DP throughput microbenchmark (sw-benchmark equivalent) of the port.

Port of ``nvbio_tpu/tools/sw_benchmark.py`` (ref: sw-benchmark/
sw-benchmark.cpp): GCUPS across aligners (edit distance, local,
semi-global and global Gotoh, Myers bit-vector edit distance) on random
near-match batches, and with ``--long`` the long-read tiers: the
long-pattern kernel, the wide-band wavefront kernel and the two-pass
wide-band CIGAR.  It prints the JAX tool's JSON row list on stdout.

``--device cuda`` (the default) runs the JAX tool's TPU sizes and every
row through a CUDA kernel (engine ``cuda``): the Gotoh rows through K1,
Myers through K6, ``gotoh_long`` through K4, ``gotoh_wide`` through K5
and ``wide_cigar`` through K5, K4 (or K2) and, for lanes past the band
ladder, K5 with flags.  ``--device cpu`` runs the JAX tool's CPU sizes
and rows through the plain versions (engine ``torch``).

    python -m nvbio_tpu_torch.tools.sw_benchmark --device cuda --long
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..alignment.types import (BOWTIE2_LOCAL_SCHEME, EDIT_DISTANCE_SCHEME,
                               AlignmentType, GotohScheme)
from ..alignment.wide import wide_band_cigar_batch
from ..device import resolve_device
from ..ops import banded_dp, long_dp
from ..ops.myers import myers


def _timed(dev, fn, iters: int) -> float:
    """Seconds per call after one warm-up call (which also builds the
    kernels), synchronised on the device."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def make_batches(on_gpu: bool, batch: int = 0, read_len: int = 100,
                 band: int = 15, long_len: int = 10_000,
                 wide_band: int = 2000):
    """The tool's batches from seed 0, in NumPy, as the JAX tool draws
    them: ``short`` (the Gotoh and Myers rows: exact copies at offset
    ``band``), ``long`` (``gotoh_long``: the same at ``long_len`` and band_w
    max(band, 63)) and ``wide`` (``gotoh_wide`` and ``wide_cigar``: 4 000
    bp at most, copied at a random offset below ``wide_band``).  Each is
    (patterns, plens, texts, tlens, band_w)."""
    rng = np.random.default_rng(0)
    NB = batch or (1 << 19 if on_gpu else 1 << 12)
    LP, W = read_len, band
    LT = LP + 2 * W
    pats = rng.integers(0, 4, (NB, LP)).astype(np.int8)
    texts = rng.integers(0, 4, (NB, LT)).astype(np.int8)
    texts[:, W:W + LP] = pats
    out = {"short": (pats, np.full(NB, LP, np.int32), texts,
                     np.full(NB, LT, np.int32), W)}

    LPL = long_len
    WL = max(band, 63)
    NBL = (1 << 10) if on_gpu else 4
    ltexts = rng.integers(0, 4, (NBL, LPL + 2 * WL)).astype(np.int8)
    lpats = rng.integers(0, 4, (NBL, LPL)).astype(np.int8)
    ltexts[:, WL:WL + LPL] = lpats
    out["long"] = (lpats, np.full(NBL, LPL, np.int32), ltexts,
                   np.full(NBL, LPL + 2 * WL, np.int32), WL)

    WW = wide_band
    NBW = 128 if on_gpu else 2
    LPW = min(LPL, 4000)
    wtexts = rng.integers(0, 4, (NBW, LPW + 2 * WW)).astype(np.int8)
    wpats = rng.integers(0, 4, (NBW, LPW)).astype(np.int8)
    off = rng.integers(0, WW, NBW)
    for b in range(NBW):
        wtexts[b, off[b]:off[b] + LPW] = wpats[b]
    out["wide"] = (wpats, np.full(NBW, LPW, np.int32), wtexts,
                   np.full(NBW, LPW + 2 * WW, np.int32), WW)
    return out


def _row(rows, aligner, engine, cells, dt, note=""):
    gcups = cells / dt / 1e9
    rows.append({"aligner": aligner, "engine": engine,
                 "gcups": round(gcups, 2), "ms": round(dt * 1e3, 2)})
    print(f"{aligner:20s} {engine:8s} {gcups:8.2f} GCUPS ({dt * 1e3:.1f} "
          f"ms{note})", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(prog="sw_benchmark", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--batch", type=int, default=0,
                   help="alignments per run (default: device-dependent)")
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--band", type=int, default=15)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--long", action="store_true",
                   help="also bench the long-read tiers (row-blocked "
                        "kernel, wide-band wavefront, two-pass CIGAR)")
    p.add_argument("--long-len", type=int, default=10_000)
    p.add_argument("--wide-band", type=int, default=2000)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    on_gpu = dev.type == "cuda"
    engine = "cuda" if on_gpu else "torch"

    def put(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    batches = make_batches(on_gpu, args.batch, args.read_len, args.band,
                           args.long_len, args.wide_band)
    *short, W = batches["short"]
    NB, LP = short[0].shape
    LT = LP + 2 * W
    arr = put(*short)

    cases = [
        ("edit_distance", EDIT_DISTANCE_SCHEME, AlignmentType.SEMI_GLOBAL),
        ("gotoh_semi_global", GotohScheme(), AlignmentType.SEMI_GLOBAL),
        ("gotoh_local", BOWTIE2_LOCAL_SCHEME, AlignmentType.LOCAL),
        ("gotoh_global", GotohScheme(), AlignmentType.GLOBAL),
    ]
    rows = []
    for cname, scheme, atype in cases:
        dt = _timed(dev, lambda s=scheme, t=atype: banded_dp.banded_score(
            *arr, scheme=s, atype=t, band_w=W), args.iters)
        _row(rows, cname, engine, NB * LP * (2 * W + 1), dt)

    # Myers bit-vector edit distance (full-matrix equivalent work)
    dt = _timed(dev, lambda: myers(*arr, atype=AlignmentType.SEMI_GLOBAL),
                args.iters)
    _row(rows, "myers_edit_distance", engine, NB * LP * LT, dt,
         ", full-matrix cells")

    if args.read_len > 512:
        print("(gotoh rows above used ops/long_dp.py — patterns beyond"
              " 512 rows)", file=sys.stderr)

    if args.long:
        *long_, WL = batches["long"]
        NBL, LPL = long_[0].shape
        larr = put(*long_)
        dt = _timed(dev, lambda: banded_dp.banded_score(
            *larr, scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
            band_w=WL), args.iters)
        _row(rows, f"gotoh_long_{LPL}", engine, NBL * LPL * (2 * WL + 1), dt)

        *wide, WW = batches["wide"]
        NBW, LPW = wide[0].shape
        warr = put(*wide)
        if on_gpu:  # the JAX tool runs this row on its kernel only
            dt = _timed(dev, lambda: long_dp.banded_score_long(
                *warr, scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
                band_w=WW), args.iters)
            _row(rows, f"gotoh_wide_{WW}", engine, NBW * LPW * (2 * WW + 1),
                 dt)

        t0 = time.perf_counter()
        out = wide_band_cigar_batch(*warr, scheme=GotohScheme(),
                                    atype=AlignmentType.SEMI_GLOBAL,
                                    band_w=WW)
        dt = time.perf_counter() - t0
        n_cig = int(out["tb_ok"].sum())
        rows.append({"aligner": f"wide_cigar_{WW}", "engine": engine,
                     "alignments_per_s": round(NBW / dt, 1),
                     "cigars": n_cig, "ms": round(dt * 1e3, 2)})
        print(f"{'wide_cigar_' + str(WW):20s} {engine:8s} {NBW / dt:8.1f} "
              f"aln/s ({dt * 1e3:.1f} ms, {n_cig}/{NBW} CIGARs)",
              file=sys.stderr)

    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
