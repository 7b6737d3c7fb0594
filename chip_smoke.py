#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nvbio_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on any
failure:

1. the card: nvidia-smi name and power limit, torch and CUDA versions;
2. the build: nvcc compiles the kernels from nvbio_tpu_torch/ops/csrc
   (one process per source, started together);
3. K1, K2, K3 against their plain PyTorch versions on the card, bit for
   bit, at the mapper's shapes (NB = 32767 windows, 128-row patterns,
   band_w = 15), for all three alignment types; K2's walk outputs too;
   CUDA-event times of kernel and plain version; K1 at bench.py's
   shape (2 097 152 x 100 bp x band 31);
4. K4 against its plain versions at the long-read path's shapes
   (score-only NB = 8192, directions NB = 1024; Lp = 2016, band_w = 63),
   for all three alignment types, flags and walks included; times;
5. the wide-band repair: K1-, K2- and K3-shaped calls at band_w = 63
   (Lp = 128, NB = 32767) launch K4 and equal the plain versions;
6. the golden dataset through build_index + map_reads --device cuda:
   SAM identical to tests/data/golden_se.sam.gz (ignoring @PG);
7. the short-read path at real size: a seeded random genome of GRCh38
   chr20's length, 100 000 simulated 100 bp reads, build_index then
   map_reads --device cuda --batch 4096 with the launch counts reset
   just before; accuracy bars, throughput, peak memory, a per-stage
   breakdown of one batch, and the first 4096 reads re-mapped with
   --device cpu to identical SAM lines;
8. the long-read path at real size: 20 000 simulated 2 kb reads on the
   same index, map_reads --max-read-len 2048 --band 63 --batch 1024
   --device cuda with the counts reset just before; K4 launched,
   accuracy bars (40 bp window), throughput, peak memory, per-stage
   breakdown, and the first 128 reads mapped under --device cuda and
   --device cpu to identical SAM lines;
9. K5 against its plain versions at sw_benchmark's wide shape (128 x
   4000 bp, band_w 2000): score-only for all three alignment types (N
   symbols, ragged and zero lengths, a GLOBAL goal outside the band),
   with flags on 8 lanes (every flag byte), the device walk over the
   kernel's flags against the host walk; times and GCUPS;
10. K6 against its plain version at 2^19 x 100 bp and 8192 x 1000 bp
   (32 words), GLOBAL and SEMI_GLOBAL; times and GCUPS;
11. sw_benchmark --device cuda --long at its defaults (the JAX tool's
   TPU sizes) with the counts reset just before: K1, K4, K5 and K6
   launched; its JSON rows recorded;
12. K4 at the shapes sw_benchmark gives it, on the tool's own batches:
   score-only at 1024 x 10 000 bp, band_w 63, and with flags and walks
   on wide_cigar's pass-2 call (128 x 4000 bp, the certificate's band),
   bit-identical to the plain versions; wide_cigar's 128 CIGARs
   re-scored, its first 4 lanes equal to a CPU run of the same lanes;
13. pass 3 of the wide-band CIGAR: wide_band_cigar_batch on 8 lanes of
   4000 bp at band_w 2000, each with one planted deletion past the 767
   band ladder (tests/test_wide_cigar.py's forced-gap scheme), with the
   counts reset just before: K5 with flags launched, every lane has a
   CIGAR that re-scores to its score and holds its planted D run.

The last line is {"ok": true, "device": {...}}; the line before it
lists the ported kernels (K1-K6, K5 as its score and its flag entry
points) as JSON, with the launches of the path that runs each (K2, K3:
the short-read run; K4: the long-read run; K1, K5, K6: sw_benchmark;
K5 with flags: the pass-3 run), the time and plain time at the phase
shapes, and the least time the card could take for the same call
(bound_ms: int32 operations over 132 SMs x 64 lanes x the max SM clock,
or bytes over 3.35 TB/s, whichever is larger).  Bulk files go to
.chip_smoke_work/ (removed at the end), a copy of the numbers to
result.json in OUT, with nvcc's ptxas report beside it.  Imports no JAX
and nothing of nvbio_tpu: a finder refuses both.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke_work")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
CHR20_BP = 64_444_167  # GRCh38 chr20 (BASELINE config 3), random sequence
N_READS = 100_000
CPU_READS = 4096
SEED = 20
NB, LP, BAND_W = 32_767, 128, 15  # extension batch of the main path
DEV = "cuda"
BENCH_NB, BENCH_LP = 2_097_152, 100  # bench.py:43-56
# the long-read path: 1024-read chunks of 2 kb reads (bucketed to 2016)
# at --band 63; their extension batch is 2 * 1024 * 16 * 0.25 lanes
LONG_NB, LONG_DIRS_NB, LONG_LP, LONG_W = 8_192, 1_024, 2_016, 63
N_LONG, LONG_LEN, LONG_CPU = 20_000, 2_000, 128
# sw_benchmark's wide batch (nvbio_tpu/tools/sw_benchmark.py:153-162):
# 128 lanes of 4000 bp at band_w 2000; K5's flags are checked on 8
WIDE_NB, WIDE_DIRS_NB, WIDE_LP, WIDE_W = 128, 8, 4_000, 2_000
# Myers: sw_benchmark's 2^19 x 100 bp, and a 32-word pattern length
MYERS_SHAPES = ((1 << 19, 100, 130), (8_192, 1_000, 1_060))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM, N_SMS = 64, 132
# int32 operations per cell, counted from the kernels' cell updates:
# Gotoh (K1, K3, K4, K5): substitution 4 (two compares, two selects),
# F 3, Hdiag 1, Hhat 1, E 3, H 1, masking and sink 2; flags add the H
# source (2 compares, 2 selects), the E/F open bits (2 compares) and
# packing (2 shifts/ors)
GOTOH_OPS, GOTOH_FLAG_OPS = 15, 23
# Myers (K6), per word of ceil(plen / 32) and text column < tlen: Peq
# select 1, xv 1, add with carry 3, xh 2, ph 3, mh 1, shifts with carry
# 6, VP 3, VN 1; per column: the end bits 2, the distance 2, the best
# distance and its column 3.  The kernel's masks to plen bits are not
# counted: bits above the end bit never reach it (adds carry upward,
# shifts go left), so the function does not need them.
MYERS_WORD_OPS, MYERS_COL_OPS = 21, 7


class _BlockJax:
    """Refuse any import of jax or of the JAX package: the GPU machine
    has no JAX, and the port keeps its own copies of what it needs."""

    def find_spec(self, name, path=None, target=None):
        if (name in ("jax", "nvbio_tpu")
                or name.startswith(("jax.", "jaxlib", "nvbio_tpu."))):
            raise ImportError(f"chip_smoke: blocked import of {name}")
        return None


sys.meta_path.insert(0, _BlockJax())
#: int32 operations per second of the card, set by phase_card
INT32_PEAK = None


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for
    ``ops`` int32 operations and ``nbytes`` bytes moved."""
    t_ops, t_bytes = ops / INT32_PEAK, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def dp_bytes(*tensors, out_bytes=0):
    """Bytes a DP call must move: every input read once, outputs once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None) + out_bytes


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_card(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    global INT32_PEAK
    INT32_PEAK = N_SMS * INT32_LANES_PER_SM * mhz * 1e6
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"max SM clock {mhz:.0f} MHz: int32 peak {N_SMS} SMs x "
        f"{INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz = "
        f"{INT32_PEAK / 1e12:.2f} Tops/s")
    return smi, mhz


def phase_build():
    from nvbio_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"[build] kernels ready in {secs:.2f}s")
    if _build.build_info is not None:
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
            f.write(_build.build_info["ptxas"])
    return secs


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def dp_inputs(np, nb, lp, band_w, genome, rng):
    """Mapper-like extension windows: 100 bp patterns (padded to lp)
    planted at small offsets in their windows with 3% substitutions and
    N, genome-end windows and zero-length lanes included.  Besides the
    window lengths, GLOBAL lengths within band_w of each pattern's, so
    that GLOBAL's goal cell lies in the band and lanes have a path."""
    n = len(genome)
    lt = lp + 2 * band_w
    ws = rng.integers(0, n - 1, nb)
    ws[:3] = [n - 1, n - 40, n - lp]
    gpad = np.concatenate([genome, np.full(lt + 16, 7, np.int8)])
    texts = gpad[ws[:, None] + np.arange(lt)]
    plens = np.minimum(rng.integers(90, 101, nb), lp).astype(np.int32)
    plens[3:6] = 0
    off = rng.integers(band_w - 5, band_w + 6, nb)
    pats = gpad[(ws + off)[:, None] + np.arange(lp)]
    pats = np.where(pats == 7, rng.integers(0, 4, pats.shape), pats)
    mut = rng.random(pats.shape) < 0.03
    pats[mut] = rng.integers(0, 5, int(mut.sum()))
    pats = np.where(np.arange(lp)[None, :] < plens[:, None], pats, 7)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    tlens = np.clip(n - ws, 0, lt).astype(np.int32)
    tlens_global = np.clip(plens + rng.integers(-band_w, band_w + 1, nb),
                           0, tlens).astype(np.int32)
    return (pats.astype(np.int8), plens, texts.astype(np.int8), tlens,
            quals, ws.astype(np.int64), tlens_global)


def long_inputs(np, nb, lp, band_w, genome, rng):
    """Long-read extension windows: patterns of 0.9-1.0 x lp planted at
    offsets within the band, with indels that drift the diagonal, 2%
    substitutions (N among them), genome-end windows and zero-length
    lanes; GLOBAL lengths within band_w of each pattern's."""
    n = len(genome)
    lt = lp + 2 * band_w
    ws = rng.integers(0, n - 1, nb)
    ws[:3] = [n - 1, n - 40, n - lp]
    gpad = np.concatenate([genome, np.full(2 * lt + 64, 7, np.int8)])
    texts = gpad[ws[:, None] + np.arange(lt)]
    plens = rng.integers(lp * 9 // 10, lp + 1, nb).astype(np.int32)
    plens[3:6] = 0
    off = rng.integers(band_w - 10, band_w + 11, nb)
    drift = np.cumsum(rng.choice(np.array([-1, 0, 1], np.int8), (nb, lp),
                                 p=[0.001, 0.998, 0.001]), axis=1)
    pats = gpad[np.maximum(ws[:, None] + off[:, None] + np.arange(lp)
                           + drift, 0)]
    pats = np.where(pats == 7, rng.integers(0, 4, pats.shape), pats)
    mut = rng.random(pats.shape) < 0.02
    pats[mut] = rng.integers(0, 5, int(mut.sum()))
    pats = np.where(np.arange(lp)[None, :] < plens[:, None], pats, 7)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    tlens = np.clip(n - ws, 0, lt).astype(np.int32)
    tlens_global = np.clip(plens + rng.integers(-band_w, band_w + 1, nb),
                           0, tlens).astype(np.int32)
    return (pats.astype(np.int8), plens, texts.astype(np.int8), tlens,
            quals, ws.astype(np.int64), tlens_global)


def walk_outputs(torch, res, dirs, band_w):
    """The run-jump walk from each lane's sink (lanes with a path)."""
    from nvbio_tpu_torch.alignment.walk import runjump_walk

    i0 = res["p_end"].long()
    k0 = res["t_end"].long() - i0 + band_w
    return runjump_walk(dirs.reshape(dirs.shape[0], -1), 2 * band_w + 1,
                        i0, k0, res["score"] > -(1 << 29))


def max_abs_err(torch, got, want):
    err = 0
    for g, w in zip(got, want):
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()) if g.numel() else 0)
    return err


def phase_kernels(torch, np):
    from nvbio_tpu_torch.alignment.batched import (banded_directions_batch,
                                                   banded_score_batch)
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.alignment.walk import runjump_walk
    from nvbio_tpu_torch.ops import banded_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, 4_000_000).astype(np.int8)
    gwords = banded_dp.pack_genome_words(genome, device=dev)
    arrays = dp_inputs(np, NB, LP, BAND_W, genome, rng)
    pats, plens, texts, win_tlens, quals, ws, global_tlens = (
        torch.from_numpy(a).to(dev) for a in arrays)
    out = {}
    worst = {"K1": 0, "K2": 0, "K3": 0}
    for atype in AlignmentType:
        tlens = (global_tlens if atype == AlignmentType.GLOBAL
                 else win_tlens)
        scheme = GotohScheme(match=2 if atype == AlignmentType.LOCAL else 0)
        kw = dict(scheme=scheme, atype=atype, band_w=BAND_W)
        keys = ("score", "p_end", "t_end")

        def k1():
            return banded_dp.banded_score(pats, plens, texts, tlens, quals,
                                          **kw)

        def p1():
            return banded_score_batch(pats, plens, texts, tlens, quals, **kw)

        def k3():
            return banded_dp.banded_score_packed(pats, plens, gwords, ws,
                                                 tlens, quals, **kw)

        def p3():
            return banded_dp.banded_score_packed_plain(
                pats, plens, gwords, ws, tlens, quals, **kw)

        def k2():
            return banded_dp.banded_directions(pats, plens, texts, tlens,
                                               quals, **kw)

        def p2():
            return banded_directions_batch(pats, plens, texts, tlens, quals,
                                           **kw)

        r1, w1 = k1(), p1()
        r3, w3 = k3(), p3()
        (r2, d2), (w2, e2) = k2(), p2()
        torch.cuda.synchronize()
        errs = {
            "K1": max_abs_err(torch, [r1[k] for k in keys],
                              [w1[k] for k in keys]),
            "K3": max_abs_err(torch, [r3[k] for k in keys],
                              [w3[k] for k in keys]),
            "K2": max_abs_err(torch, [r2[k] for k in keys] + [d2],
                              [w2[k] for k in keys] + [e2]),
        }
        # K1 and K3 read the same windows: they must agree with each other
        errs["K3"] = max(errs["K3"], max_abs_err(
            torch, [r3[k] for k in keys], [r1[k] for k in keys]))
        # the walk over the kernel's flags equals the walk over the plain
        # version's flags
        stride = 2 * BAND_W + 1
        i0 = r2["p_end"].long()
        k0 = r2["t_end"].long() - i0 + BAND_W
        active = r2["score"] > -(1 << 29)
        walk_k = runjump_walk(d2.reshape(NB, -1), stride, i0, k0, active)
        walk_p = runjump_walk(e2.reshape(NB, -1), stride, w2["p_end"].long(),
                              w2["t_end"].long() - w2["p_end"].long()
                              + BAND_W, w2["score"] > -(1 << 29))
        errs["K2"] = max(errs["K2"], max_abs_err(torch, walk_k, walk_p))
        worst = {k: max(worst[k], errs[k]) for k in worst}
        bad = {k: v for k, v in errs.items() if v}
        if bad:
            fail(f"kernels differ from their plain versions ({atype.name}):"
                 f" max_abs_err {bad}")
        n_ok = int(active.sum())
        if n_ok < NB // 2:
            fail(f"{atype.name}: only {n_ok} of {NB} lanes have a path, "
                 "too few for the comparison to mean much")
        log(f"[kernels] {atype.name}: K1, K2 (+walk), K3 bit-identical to "
            f"the plain versions over {NB} windows ({n_ok} with a path)")
        if atype != AlignmentType.SEMI_GLOBAL:  # the mapper's type
            continue
        cells = int(plens.clamp(max=LP).sum()) * (2 * BAND_W + 1)
        cells2 = NB * LP * (2 * BAND_W + 1)
        io = (pats, quals, plens, tlens)
        for name, kern, plain, c, ops, nbytes in (
                ("K1", k1, p1, cells, GOTOH_OPS,
                 dp_bytes(*io, texts, out_bytes=12 * NB)),
                ("K3", k3, p3, cells, GOTOH_OPS,
                 dp_bytes(*io, gwords, ws, out_bytes=12 * NB)),
                ("K2", k2, p2, cells2, GOTOH_FLAG_OPS,
                 dp_bytes(*io, texts, out_bytes=12 * NB + cells2))):
            ms, pms = cuda_ms(torch, kern, 10), cuda_ms(torch, plain, 2)
            bms, by = bound(c * ops, nbytes)
            out[name] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                         "bound_by": by, "cells": c,
                         "gcups": c / ms / 1e6, "plain_gcups": c / pms / 1e6}
            log(f"[kernels] {name} SEMI_GLOBAL NB={NB} Lp={LP} "
                f"band_w={BAND_W}: kernel {ms:.3f} ms ({c / ms / 1e6:.1f} "
                f"GCUPS), plain {pms:.3f} ms ({c / pms / 1e6:.2f} GCUPS)")
    for name in out:  # over all three alignment types
        out[name]["max_abs_err"] = worst[name]
    return out


def phase_k4(torch, np):
    """K4 score-only and with flags against the plain versions at the
    long-read path's shapes, all three alignment types; times."""
    from nvbio_tpu_torch.alignment.batched import (banded_directions_batch,
                                                   banded_score_batch)
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.ops import long_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 4)
    genome = rng.integers(0, 4, 8_000_000).astype(np.int8)
    arrays = long_inputs(np, LONG_NB, LONG_LP, LONG_W, genome, rng)
    pats, plens, texts, win_tlens, quals, _, global_tlens = (
        torch.from_numpy(a).to(dev) for a in arrays)
    nd = LONG_DIRS_NB
    keys = ("score", "p_end", "t_end")
    worst, out = 0, {}
    for atype in AlignmentType:
        tlens = (global_tlens if atype == AlignmentType.GLOBAL
                 else win_tlens)
        kw = dict(scheme=GotohScheme(match=2 if atype == AlignmentType.LOCAL
                                     else 0), atype=atype, band_w=LONG_W)
        args = (pats, plens, texts, tlens, quals)
        dargs = tuple(a[:nd] for a in args)

        def k4():
            return long_dp.banded_score_long(*args, **kw)

        def p4():
            return banded_score_batch(*args, **kw)

        def k4d():
            return long_dp.banded_directions_long(*dargs, **kw)

        def p4d():
            return banded_directions_batch(*dargs, **kw)

        (r, w), ((rd, dd), (wd, ed)) = (k4(), p4()), (k4d(), p4d())
        torch.cuda.synchronize()
        err = max(
            max_abs_err(torch, [r[k] for k in keys], [w[k] for k in keys]),
            max_abs_err(torch, [rd[k] for k in keys] + [dd],
                        [wd[k] for k in keys] + [ed]),
            max_abs_err(torch, walk_outputs(torch, rd, dd, LONG_W),
                        walk_outputs(torch, wd, ed, LONG_W)))
        n_ok = int((w["score"] > -(1 << 29)).sum())
        if err:
            fail(f"K4 differs from its plain versions ({atype.name}): "
                 f"max_abs_err {err}")
        if n_ok < LONG_NB // 2:
            fail(f"K4 {atype.name}: only {n_ok} of {LONG_NB} lanes have a "
                 "path, too few for the comparison to mean much")
        worst = max(worst, err)
        log(f"[k4] {atype.name}: score-only over {LONG_NB} windows "
            f"({n_ok} with a path) and flags + walks over {nd} windows "
            f"bit-identical to the plain versions (Lp {LONG_LP}, band_w "
            f"{LONG_W})")
        if atype != AlignmentType.SEMI_GLOBAL:  # the mapper's type
            continue
        band = 2 * LONG_W + 1
        cells = int(plens.clamp(max=LONG_LP).sum()) * band
        cells_d = nd * LONG_LP * band
        ms, pms = cuda_ms(torch, k4, 10), cuda_ms(torch, p4, 2)
        dms, dpms = cuda_ms(torch, k4d, 10), cuda_ms(torch, p4d, 2)
        bms, by = bound(cells * GOTOH_OPS,
                        dp_bytes(*args, out_bytes=12 * LONG_NB))
        dbms, dby = bound(cells_d * GOTOH_FLAG_OPS,
                          dp_bytes(*dargs, out_bytes=12 * nd + cells_d))
        out = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
               "dirs_bound_ms": dbms, "dirs_bound_by": dby,
               "gcups": cells / ms / 1e6,
               "plain_gcups": cells / pms / 1e6, "dirs_ms": dms,
               "dirs_plain_ms": dpms, "dirs_gcups": cells_d / dms / 1e6,
               "dirs_plain_gcups": cells_d / dpms / 1e6}
        log(f"[k4] SEMI_GLOBAL score-only NB={LONG_NB}: kernel {ms:.3f} ms "
            f"({out['gcups']:.1f} GCUPS), plain {pms:.1f} ms "
            f"({out['plain_gcups']:.2f} GCUPS); with flags NB={nd}: kernel "
            f"{dms:.3f} ms ({out['dirs_gcups']:.1f} GCUPS), plain "
            f"{dpms:.1f} ms ({out['dirs_plain_gcups']:.2f} GCUPS)")
    out["max_abs_err"] = worst
    return out


def phase_wide_band(torch, np):
    """--band 63 on short reads: K1-, K2- and K3-shaped calls route to
    K4 (its launch count moves, theirs do not) and equal the plain
    versions."""
    from nvbio_tpu_torch.alignment.batched import (banded_directions_batch,
                                                   banded_score_batch)
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.ops import banded_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 5)
    genome = rng.integers(0, 4, 4_000_000).astype(np.int8)
    gwords = banded_dp.pack_genome_words(genome, device=dev)
    arrays = dp_inputs(np, NB, LP, LONG_W, genome, rng)
    pats, plens, texts, win_tlens, quals, ws, global_tlens = (
        torch.from_numpy(a).to(dev) for a in arrays)
    keys = ("score", "p_end", "t_end")
    out = {}
    for atype in AlignmentType:
        tlens = (global_tlens if atype == AlignmentType.GLOBAL
                 else win_tlens)
        kw = dict(scheme=GotohScheme(match=2 if atype == AlignmentType.LOCAL
                                     else 0), atype=atype, band_w=LONG_W)
        args = (pats, plens, texts, tlens, quals)
        banded_dp.reset_launch_counts()
        r1 = banded_dp.banded_score(*args, **kw)
        r3 = banded_dp.banded_score_packed(pats, plens, gwords, ws, tlens,
                                           quals, **kw)
        r2, d2 = banded_dp.banded_directions(*args, **kw)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
        if counts != {"K1": 0, "K2": 0, "K3": 0, "K4": 3, "K5": 0,
                      "K5_dirs": 0, "K6": 0}:
            fail(f"band_w {LONG_W} calls did not all route to K4: {counts}")
        w1 = banded_score_batch(*args, **kw)
        w3 = banded_dp.banded_score_packed_plain(pats, plens, gwords, ws,
                                                 tlens, quals, **kw)
        w2, e2 = banded_directions_batch(*args, **kw)
        err = max(
            max_abs_err(torch, [r1[k] for k in keys], [w1[k] for k in keys]),
            max_abs_err(torch, [r3[k] for k in keys], [w3[k] for k in keys]),
            max_abs_err(torch, [r2[k] for k in keys] + [d2],
                        [w2[k] for k in keys] + [e2]),
            max_abs_err(torch, walk_outputs(torch, r2, d2, LONG_W),
                        walk_outputs(torch, w2, e2, LONG_W)))
        if err:
            fail(f"wide-band K4 differs from the plain versions "
                 f"({atype.name}): max_abs_err {err}")
        log(f"[wide] {atype.name}: K1-, K2-, K3-shaped calls at band_w "
            f"{LONG_W} (NB={NB}, Lp={LP}) launched K4 ({counts}) and are "
            "bit-identical to the plain versions, walks included")
        out[atype.name] = counts
        if atype == AlignmentType.SEMI_GLOBAL:
            ms = cuda_ms(torch, lambda: banded_dp.banded_directions(
                *args, **kw), 10)
            pms = cuda_ms(torch, lambda: banded_directions_batch(*args, **kw),
                          2)
            out["k2_shaped_ms"], out["k2_shaped_plain_ms"] = ms, pms
            log(f"[wide] K2-shaped SEMI_GLOBAL through K4: {ms:.3f} ms, "
                f"plain {pms:.1f} ms")
    return out


def phase_bench_k1(torch, np):
    """K1 at bench.py's problem shape (all rows full length)."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.ops import banded_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(0)
    lt = BENCH_LP + 2 * BAND_W
    pats = torch.from_numpy(rng.integers(0, 4, (BENCH_NB, BENCH_LP),
                                         dtype=np.int8)).to(dev)
    texts = torch.from_numpy(rng.integers(0, 4, (BENCH_NB, lt),
                                          dtype=np.int8)).to(dev)
    texts[:, BAND_W:BAND_W + BENCH_LP] = pats
    for _ in range(3):  # sprinkle mutations, as bench.py does
        ii = torch.from_numpy(rng.integers(0, lt, BENCH_NB)).to(dev)
        texts[torch.arange(BENCH_NB, device=dev), ii] = torch.from_numpy(
            rng.integers(0, 4, BENCH_NB, dtype=np.int8)).to(dev)
    plens = torch.full((BENCH_NB,), BENCH_LP, dtype=torch.int32, device=dev)
    tlens = torch.full((BENCH_NB,), lt, dtype=torch.int32, device=dev)
    quals = torch.from_numpy(rng.integers(20, 41, (BENCH_NB, BENCH_LP),
                                          dtype=np.uint8)).to(dev)
    kw = dict(scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
              band_w=BAND_W)
    args = (pats, plens, texts, tlens, quals)
    got = banded_dp.banded_score(*args, **kw)
    want = banded_score_batch(*args, **kw)
    err = max_abs_err(torch, list(got.values()), list(want.values()))
    if err:
        fail(f"K1 differs from its plain version at bench shape: {err}")
    cells = BENCH_NB * BENCH_LP * (2 * BAND_W + 1)
    ms = cuda_ms(torch, lambda: banded_dp.banded_score(*args, **kw), 5)
    pms = cuda_ms(torch, lambda: banded_score_batch(*args, **kw), 1)
    log(f"[bench] K1 {BENCH_NB} x {BENCH_LP} bp x band {2 * BAND_W + 1}: "
        f"{ms:.2f} ms = {cells / ms / 1e6:.1f} GCUPS (plain version "
        f"{pms:.1f} ms = {cells / pms / 1e6:.2f} GCUPS), bit-identical")
    return {"ms": ms, "gcups": cells / ms / 1e6, "plain_ms": pms,
            "plain_gcups": cells / pms / 1e6}


def wide_inputs(np, nb, lp, band_w, rng):
    """sw_benchmark's wide batch (pattern planted at a random offset in
    a 2 * band_w wider text), with substitutions, N and one short indel
    per lane; lane 0 has a zero-length pattern, lane 1 a zero-length
    text, lane 2 ragged lengths and lane 3 a GLOBAL goal outside the
    band (its text ends 2.5 band widths short of the pattern)."""
    lt = lp + 2 * band_w
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int8)
    for b in range(nb):
        off = int(rng.integers(0, band_w))
        cut = int(rng.integers(1, lp))
        seg = np.concatenate([pats[b, :cut], rng.integers(0, 4, 30),
                              pats[b, cut:]]).astype(np.int8)
        mut = rng.random(len(seg)) < 0.02
        seg[mut] = rng.integers(0, 5, int(mut.sum()))
        texts[b, off:off + len(seg)] = seg[:lt - off]
    pats[rng.random(pats.shape) < 0.005] = 4
    plens = np.full(nb, lp, np.int32)
    tlens = np.full(nb, lt, np.int32)
    plens[0], tlens[1] = 0, 0
    plens[2], tlens[2] = lp - 333, lt - 777
    tlens[3] = lp - band_w - 500
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    return pats, plens, texts, tlens, quals


def k5_cells(torch, plens, tlens, band_w):
    """In-band cells a K5 call needs (score-only or with flags): rows
    1..plen, columns 0..tlen."""
    cells = 0
    for p, t in zip(plens.tolist(), tlens.tolist()):
        r = torch.arange(1, max(p, 0) + 1, dtype=torch.int64)
        lo = (r - band_w).clamp(min=0)
        hi = (r + band_w).clamp(max=t)
        cells += int((hi - lo + 1).clamp(min=0).sum())
    return cells


def phase_k5(torch, np):
    """K5 against its plain versions at sw_benchmark's wide shape."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.alignment.wavefront_walk import (
        walk_wavefront_dirs, walk_wavefront_dirs_device)
    from nvbio_tpu_torch.ops import wavefront_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 6)
    arrays = wide_inputs(np, WIDE_NB, WIDE_LP, WIDE_W, rng)
    pats, plens, texts, tlens, quals = (torch.from_numpy(a).to(dev)
                                        for a in arrays)
    args = (pats, plens, texts, tlens, quals)
    nd = WIDE_DIRS_NB
    dargs = tuple(a[:nd] for a in args)
    keys = ("score", "p_end", "t_end")
    out, worst = {}, 0
    for atype in AlignmentType:
        kw = dict(scheme=GotohScheme(match=2 if atype == AlignmentType.LOCAL
                                     else 0), atype=atype, band_w=WIDE_W)

        def k5():
            return wavefront_dp.wavefront_score(*args, **kw)

        def p5():
            return banded_score_batch(*args, twin=True, **kw)

        r, w = k5(), p5()
        torch.cuda.synchronize()
        err = max_abs_err(torch, [r[k] for k in keys], [w[k] for k in keys])
        n_ok = int((w["score"] > -(1 << 29)).sum())
        if err:
            fail(f"K5 differs from its plain version ({atype.name}): "
                 f"max_abs_err {err}")
        if n_ok < WIDE_NB // 2:
            fail(f"K5 {atype.name}: only {n_ok} of {WIDE_NB} lanes have a "
                 "path, too few for the comparison to mean much")
        worst = max(worst, err)
        log(f"[k5] {atype.name}: score-only over {WIDE_NB} lanes ({n_ok} "
            f"with a path) bit-identical to the plain version (Lp "
            f"{WIDE_LP}, Lt {WIDE_LP + 2 * WIDE_W}, band_w {WIDE_W})")
        if atype != AlignmentType.SEMI_GLOBAL:  # sw_benchmark's type
            continue
        cells = k5_cells(torch, plens.cpu(), tlens.cpu(), WIDE_W)
        ms, pms = cuda_ms(torch, k5, 5), cuda_ms(torch, p5, 1)
        bms, by = bound(cells * GOTOH_OPS,
                        dp_bytes(*args, out_bytes=12 * WIDE_NB))
        row_cells = WIDE_NB * WIDE_LP * (2 * WIDE_W + 1)
        out["K5"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by, "cells": cells,
                     "gcups": row_cells / ms / 1e6,
                     "plain_gcups": row_cells / pms / 1e6}
        log(f"[k5] SEMI_GLOBAL score-only NB={WIDE_NB}: kernel {ms:.3f} ms "
            f"({row_cells / ms / 1e6:.1f} GCUPS as sw_benchmark counts, "
            f"{cells / ms / 1e6:.1f} over the {cells} cells visited), plain "
            f"{pms:.1f} ms; bound {bms:.3f} ms ({by})")

        def k5d():
            return wavefront_dp.wavefront_dirs(*dargs, **kw)

        def p5d():
            return wavefront_dp.wavefront_dirs_plain(*dargs, **kw)

        (rd, dd), (wd, ed) = k5d(), p5d()
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, [rd[k] for k in keys] + [dd],
                              [wd[k] for k in keys] + [ed]),
                  max_abs_err(torch, [rd[k] for k in keys],
                              [r[k][:nd] for k in keys]))
        walk = walk_wavefront_dirs_device(dd, rd["p_end"], rd["t_end"],
                                          band_w=WIDE_W)
        walk_p = walk_wavefront_dirs_device(ed, wd["p_end"], wd["t_end"],
                                            band_w=WIDE_W)
        err = max(err, max_abs_err(torch, walk, walk_p))
        ops, n, ps, ts = (x.cpu().numpy() for x in walk)
        dd_h = dd.cpu().numpy()
        for b in range(nd):  # the host walk gives the same runs
            ro, rl, hps, hts = walk_wavefront_dirs(
                dd_h[b], WIDE_W, int(rd["p_end"][b]), int(rd["t_end"][b]))
            seq = np.repeat(ro, rl)
            if (hps, hts) != (ps[b], ts[b]) or not np.array_equal(
                    seq, ops[b, :n[b]]):
                fail(f"K5 flags: device walk != host walk on lane {b}")
        if err:
            fail(f"K5 with flags differs from its plain version: "
                 f"max_abs_err {err}")
        worst = max(worst, err)
        # the cells the call needs (lane 0 has plen 0, lane 1 tlen 0,
        # lanes 2 and 3 are short), 4 bits of flags each
        cells_d = k5_cells(torch, plens[:nd].cpu(), tlens[:nd].cpu(), WIDE_W)
        row_cells_d = nd * WIDE_LP * (2 * WIDE_W + 1)
        dms, dpms = cuda_ms(torch, k5d, 3), cuda_ms(torch, p5d, 1)
        dbms, dby = bound(cells_d * GOTOH_FLAG_OPS,
                          dp_bytes(*dargs, out_bytes=12 * nd + cells_d // 2))
        out["K5_dirs"] = {"ms": dms, "plain_ms": dpms, "bound_ms": dbms,
                          "bound_by": dby, "cells": cells_d,
                          "flag_bytes": dd.numel(),
                          "gcups": cells_d / dms / 1e6,
                          "plain_gcups": cells_d / dpms / 1e6,
                          "tool_gcups": row_cells_d / dms / 1e6}
        log(f"[k5] with flags NB={nd}: every flag byte ({dd.numel()}) and "
            f"the device walk equal the plain version's, device walk = "
            f"host walk; kernel {dms:.3f} ms ({cells_d / dms / 1e6:.1f} "
            f"GCUPS over the {cells_d} cells needed, "
            f"{row_cells_d / dms / 1e6:.1f} as sw_benchmark counts), plain "
            f"{dpms:.1f} ms; bound {dbms:.3f} ms ({dby})")
        del dd, ed, rd, wd
    out["K5"]["max_abs_err"] = out["K5_dirs"]["max_abs_err"] = worst
    return out


def phase_k6(torch, np):
    """K6 against its plain version at sw_benchmark's shape and at a
    32-word pattern length, GLOBAL and SEMI_GLOBAL."""
    from nvbio_tpu_torch.alignment.myers import myers_edit_distance_batch
    from nvbio_tpu_torch.alignment.types import AlignmentType
    from nvbio_tpu_torch.ops import myers

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 7)
    out, worst = {}, 0
    for nb, lp, lt in MYERS_SHAPES:
        pats = rng.integers(0, 4, (nb, lp)).astype(np.int8)
        texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
        off = (lt - lp) // 2
        texts[:, off:off + lp] = pats
        mut = rng.random(texts.shape) < 0.03
        texts[mut] = rng.integers(0, 5, int(mut.sum()))
        plens = np.full(nb, lp, np.int32)
        tlens = np.full(nb, lt, np.int32)
        plens[:3], tlens[3:5] = (0, 1, lp // 3), (0, lt // 2)
        args = [torch.from_numpy(a).to(dev)
                for a in (pats, plens, texts, tlens)]
        words = (lp + 31) // 32
        for atype in (AlignmentType.GLOBAL, AlignmentType.SEMI_GLOBAL):
            def k6():
                return myers.myers(*args, atype=atype)

            def p6():
                return myers_edit_distance_batch(*args, atype=atype)

            err = max_abs_err(torch, list(k6()), list(p6()))
            if err:
                fail(f"K6 differs from its plain version ({atype.name}, "
                     f"Lp {lp}): max_abs_err {err}")
            worst = max(worst, err)
            if atype != AlignmentType.SEMI_GLOBAL:
                continue
            ms, pms = cuda_ms(torch, k6, 10), cuda_ms(torch, p6, 1)
            cells = nb * lp * lt  # full-matrix cells (sw_benchmark.py:93)
            # the words and columns the function needs, lane by lane
            pl = plens.astype(np.int64)
            cols = np.where(pl > 0, tlens.clip(0, lt), 0).astype(np.int64)
            work = int((cols * ((pl + 31) // 32)).sum())
            ops = MYERS_WORD_OPS * work + MYERS_COL_OPS * int(cols.sum())
            bms, by = bound(ops, dp_bytes(*args, out_bytes=8 * nb))
            out[f"{nb}x{lp}"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                                 "bound_by": by, "word_columns": work,
                                 "gcups": cells / ms / 1e6,
                                 "plain_gcups": cells / pms / 1e6}
            log(f"[k6] {nb} x {lp} bp ({words} words): GLOBAL and "
                "SEMI_GLOBAL bit-identical to the plain version; SEMI_GLOBAL"
                f" kernel {ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS, "
                f"full-matrix cells), plain {pms:.1f} ms; bound {bms:.3f} ms"
                f" ({by})")
    tool_shape = out[f"{MYERS_SHAPES[0][0]}x{MYERS_SHAPES[0][1]}"]
    return dict(tool_shape, max_abs_err=worst, shapes=out)


def phase_sw_benchmark(torch):
    """sw_benchmark --device cuda --long at its defaults."""
    import contextlib
    import io

    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.tools.sw_benchmark import main as swb

    buf = io.StringIO()
    banded_dp.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = swb(["--device", DEV, "--long"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    rows = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or any(launches[k] < 1 for k in ("K1", "K4", "K5", "K6")):
        fail(f"sw_benchmark --long did not launch K1, K4, K5 and K6: "
             f"rc {rc}, launches {launches}")
    if {r["engine"] for r in rows} != {"cuda"}:
        fail(f"sw_benchmark rows not all on the kernels: {rows}")
    for r in rows:
        log(f"[sw_benchmark] {json.dumps(r)}")
    log(f"[sw_benchmark] --device cuda --long: {secs:.1f}s; launches "
        f"{launches}")
    return {"rows": rows, "launches": launches, "seconds": secs}


def rescore(scheme, pats, texts, quals, out, b):
    """Lane b's CIGAR (out's runs, end to start) re-scored from its start
    cell on host arrays: (score, p_end, t_end) it attains, and its runs
    as (op, length) pairs."""
    from nvbio_tpu_torch.alignment.types import gap_penalties

    eo, ee, fo, fe = gap_penalties(scheme)
    runs = [(int(o), int(n)) for o, n in zip(out["run_ops"][b],
                                             out["run_lens"][b]) if n]
    i, j, sc = int(out["p_start"][b]), int(out["t_start"][b]), 0
    for op, n in runs[::-1]:  # start to end
        if op == 1:
            for _ in range(n):
                q = 40 if quals is None else int(quals[b, i])
                sc += scheme.substitution(int(pats[b, i]), int(texts[b, j]),
                                          q)
                i, j = i + 1, j + 1
        elif op == 2:
            sc, j = sc - eo - n * ee, j + n
        else:
            sc, i = sc - fo - n * fe, i + n
    return (sc, i, j), runs


def phase_tool_shapes(torch, np):
    """K4 at the shapes sw_benchmark --long gives it, against its plain
    versions on the tool's own batches: score-only on the gotoh_long
    batch (1024 x 10 000 bp, band_w 63) and, with flags and the run-jump
    walk, on wide_cigar's pass-2 call (128 x 4000 bp at the band the
    certificate picks); wide_cigar's 128 CIGARs re-scored, and its first
    lanes equal to the same lanes run on the CPU."""
    from nvbio_tpu_torch.alignment.batched import (banded_directions_batch,
                                                   banded_score_batch)
    from nvbio_tpu_torch.alignment.types import (NEG_INF, AlignmentType,
                                                 GotohScheme)
    from nvbio_tpu_torch.alignment.wide import (_quantize_band,
                                                derive_tb_band, pass2_window,
                                                wide_band_cigar_batch)
    from nvbio_tpu_torch.ops import banded_dp, long_dp
    from nvbio_tpu_torch.tools.sw_benchmark import make_batches

    dev = torch.device(DEV)
    batches = make_batches(on_gpu=True)
    scheme = GotohScheme()
    kw = dict(scheme=scheme, atype=AlignmentType.SEMI_GLOBAL)
    keys = ("score", "p_end", "t_end")

    *long_, wl = batches["long"]
    larr = [torch.from_numpy(a).to(dev) for a in long_]
    banded_dp.reset_launch_counts()
    got = banded_dp.banded_score(*larr, band_w=wl, **kw)
    n_k4 = banded_dp.KERNELS["K4"].launches
    want = banded_score_batch(*larr, band_w=wl, **kw)
    err = max_abs_err(torch, [got[k] for k in keys], [want[k] for k in keys])
    if err or n_k4 != 1:
        fail(f"K4 at gotoh_long's shape {tuple(long_[0].shape)}, band_w "
             f"{wl}: max_abs_err {err}, K4 launches {n_k4}")
    log(f"[tool] K4 score-only on gotoh_long's batch "
        f"({long_[0].shape[0]} x {long_[0].shape[1]} bp, band_w {wl}) "
        "bit-identical to the plain version")
    del larr, got, want

    *wide, ww = batches["wide"]
    nb, lp = wide[0].shape
    warr = [torch.from_numpy(a).to(dev) for a in wide]
    res1 = long_dp.banded_score_long(*warr, band_w=ww, **kw)
    score, p_end, t_end = (res1[k].cpu().numpy().astype(np.int64)
                           for k in keys)
    need, off = derive_tb_band(wide[1], score, p_end, t_end, scheme, ww)
    b2 = _quantize_band(int(need.max()))
    if not (score > NEG_INF // 2).all() or b2 is None:
        fail(f"wide_cigar's batch: pass 1 left lanes without a path or "
             f"past the band ladder (need up to {int(need.max())})")
    texts2, tlens2 = pass2_window(warr[2], warr[3], off, lp, b2)
    p2 = (warr[0], warr[1], texts2, tlens2)
    banded_dp.reset_launch_counts()
    rd, dd = banded_dp.banded_directions(*p2, band_w=b2, **kw)
    n_k4 = banded_dp.KERNELS["K4"].launches
    wd, ed = banded_directions_batch(*p2, band_w=b2, **kw)
    err = max(max_abs_err(torch, [rd[k] for k in keys] + [dd],
                          [wd[k] for k in keys] + [ed]),
              max_abs_err(torch, walk_outputs(torch, rd, dd, b2),
                          walk_outputs(torch, wd, ed, b2)))
    if err or n_k4 != 1:
        fail(f"K4 with flags at wide_cigar's pass-2 shape ({nb} x {lp} bp, "
             f"band_w {b2}): max_abs_err {err}, K4 launches {n_k4}")
    log(f"[tool] K4 with flags on wide_cigar's pass-2 call ({nb} x {lp} "
        f"bp, band_w {b2}): results, every flag and the run-jump walks "
        "bit-identical to the plain version")
    del dd, ed

    out = wide_band_cigar_batch(*warr, band_w=ww, **kw)
    for b in range(nb):
        (sc, i, j), _ = rescore(scheme, wide[0], wide[2], None, out, b)
        if not (out["tb_ok"][b] and (sc, i, j) == (
                out["score"][b], out["p_end"][b], out["t_end"][b])):
            fail(f"wide_cigar lane {b}: tb_ok {out['tb_ok'][b]}, CIGAR "
                 f"re-scores to {(sc, i, j)}, not "
                 f"{(out['score'][b], out['p_end'][b], out['t_end'][b])}")
    n_cpu = 4
    cpu = wide_band_cigar_batch(
        *[torch.from_numpy(a[:n_cpu]) for a in wide], band_w=ww, **kw)
    for k, v in cpu.items():
        a, c = np.asarray(out[k])[:n_cpu], np.asarray(v)
        if k in ("run_ops", "run_lens"):  # widths follow the batch
            w = max(a.shape[1], c.shape[1])
            a = np.pad(a, ((0, 0), (0, w - a.shape[1])))
            c = np.pad(c, ((0, 0), (0, w - c.shape[1])))
        if not np.array_equal(a, c):
            fail(f"wide_cigar: {k} of the first {n_cpu} lanes differs "
                 "between --device cuda and the same lanes on the CPU")
    log(f"[tool] wide_cigar's {nb} CIGARs re-score to their scores and "
        f"ends; the first {n_cpu} lanes equal the CPU run in every output")
    return {"long_shape": list(long_[0].shape), "long_band_w": wl,
            "pass2_shape": [nb, lp], "pass2_band_w": b2,
            "cigars_rescored": nb, "cpu_lanes": n_cpu}


def phase_pass3(torch, np):
    """wide_band_cigar_batch on 8 lanes whose certificate passes the 767
    ladder (one planted deletion each), through K5 with flags."""
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.alignment.wide import (TB_BANDS, derive_tb_band,
                                                wide_band_cigar_batch)
    from nvbio_tpu_torch.ops import banded_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 8)
    # tests/test_wide_cigar.py's forced-gap scheme: cheap text-gap
    # extension, costly opens, mismatches and pattern gaps
    scheme = GotohScheme(match=2, mismatch_min=6, mismatch_max=6,
                         gap_open=50, gap_extend=1, ref_gap_open=30,
                         ref_gap_extend=10)
    nb, lp, band_w = WIDE_DIRS_NB, WIDE_LP, WIDE_W
    lt = lp + 2 * band_w
    gaps = rng.integers(850, 1600, nb)
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int8)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    for b in range(nb):
        cut = int(rng.integers(lp // 4, 3 * lp // 4))
        t = np.concatenate([pats[b, :cut],
                            rng.integers(0, 4, gaps[b]).astype(np.int8),
                            pats[b, cut:]])
        texts[b, :min(len(t), lt)] = t[:lt]
    plens = np.full(nb, lp, np.int32)
    tlens = np.full(nb, lt, np.int32)
    quals = np.full((nb, lp), 35, np.int32)
    args = [torch.from_numpy(a).to(dev)
            for a in (pats, plens, texts, tlens, quals)]
    banded_dp.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = wide_band_cigar_batch(*args, scheme=scheme,
                                atype=AlignmentType.SEMI_GLOBAL,
                                band_w=band_w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    need, _ = derive_tb_band(plens, out["score"], out["p_end"],
                             out["t_end"], scheme, band_w)
    for b in range(nb):
        (sc, i, j), runs = rescore(scheme, pats, texts, quals, out, b)
        if not (out["tb_ok"][b] and need[b] > TB_BANDS[-1]
                and (sc, i, j) == (out["score"][b], out["p_end"][b],
                                   out["t_end"][b])
                and (2, int(gaps[b])) in runs):
            fail(f"pass 3, lane {b}: tb_ok {out['tb_ok'][b]}, need "
                 f"{need[b]}, re-scored {(sc, i, j)} vs "
                 f"{(out['score'][b], out['p_end'][b], out['t_end'][b])}, "
                 f"planted {gaps[b]}D in runs: {(2, int(gaps[b])) in runs}")
    if launches["K5_dirs"] < 1:
        fail(f"pass 3 did not launch K5 with flags: {launches}")
    log(f"[pass3] {nb} lanes x {lp} bp at band_w {band_w}, planted "
        f"deletions {gaps.tolist()} (certificates {need.tolist()} > "
        f"{TB_BANDS[-1]}): every CIGAR re-scores to its score and holds its "
        f"D run; {secs * 1e3:.1f} ms (host clock); launches {launches}")
    return {"launches": launches, "ms": secs * 1e3, "gaps": gaps.tolist(),
            "need": need.tolist()}


def sam_records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def phase_golden(torch):
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads
    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr
    import numpy as np

    d = os.path.join(WORK, "golden")
    os.makedirs(d, exist_ok=True)
    # generated exactly as tests/test_golden.py does
    g = random_genome(200_000, seed=12345)
    write_fasta(f"{d}/g.fa", [("golden_ref", g)])
    sim = simulate_reads(g, 300, 100, seed=54321, error_rate=0.02,
                         indel_rate=0.005)
    write_fastq(f"{d}/r.fq", [
        (f"gr{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(300)])
    build([f"{d}/g.fa", f"{d}/g.npz"])
    banded_dp.reset_launch_counts()
    mapr(["-x", f"{d}/g.npz", "-U", f"{d}/r.fq", "-S", f"{d}/out.sam",
          "--device", DEV, "--batch", "128"])
    counts = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    got = [ln for ln in open(f"{d}/out.sam") if not ln.startswith("@PG")]
    want = list(gzip.open(os.path.join(ROOT, "tests", "data",
                                       "golden_se.sam.gz"), "rt"))
    if got != want:
        n_diff = sum(a != b for a, b in zip(got, want))
        fail(f"golden SAM differs under --device cuda ({n_diff} lines, "
             f"{len(got)} vs {len(want)})")
    if not (counts["K3"] > 0 and counts["K2"] > 0):
        fail(f"golden run did not launch K3 and K2: {counts}")
    log(f"[golden] SAM byte-identical to golden_se.sam.gz under --device "
        f"cuda ({len(got)} lines; launches {counts})")
    return counts


def stage_breakdown(torch, np, npz, reads_fq, batch=4096, max_len=320,
                    band_w=15):
    """Host-clock ms per stage (synchronised) for full batches of a
    real-size run; the median of batches 2-4."""
    from nvbio_tpu_torch.io.sequence import ReadBatchIterator
    from nvbio_tpu_torch.io.index_file import load_index
    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.models.params import MapperParams
    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.strings.string_set import pack_reads

    dev = torch.device(DEV)
    fm, ssa, genome, meta = load_index(npz, device=dev)
    params = MapperParams(seed_interval_fn="S", seed_interval_a=1.0,
                          seed_interval_b=1.15, batch_size=batch,
                          max_read_len=max_len, band_w=band_w,
                          sa_sample=meta["sa_sample"], lut_k=meta["lut_k"])
    m = M.Mapper(fm, ssa, genome, params=params, lut=meta["lut"])
    rows = []
    batches = iter(ReadBatchIterator(reads_fq, batch))
    for _ in range(4):
        names, seqs, quals = next(batches, (None, None, None))
        if names is None:
            break
        reads, lens, qmat, _ = pack_reads(seqs, quals, max_len=max_len)
        reads, qmat = m._len_bucket(reads, lens, qmat)
        p = m._chunk_params(lens.max(), lens.min())
        ext_k = banded_dp.route(reads.shape[1], band_w, False, packed=True)
        tb_k = banded_dp.route(reads.shape[1], band_w, True)
        t = {}

        def mark(name, t0):
            torch.cuda.synchronize()
            t[name] = (time.perf_counter() - t0) * 1e3
            return time.perf_counter()

        t0 = time.perf_counter()
        jr = torch.from_numpy(reads).to(dev)
        jl = torch.from_numpy(lens.astype(np.int64)).to(dev)
        jq = torch.from_numpy(qmat).to(dev)
        t0 = mark("upload", t0)
        ushift = reads.shape[1] - int(lens.max())
        all_r, all_q, lens2 = M.both_strands(jr, jl, jq, ushift)
        lo, hi, offs, sval, _ = M.seed_and_search(m.fm, all_r, lens2,
                                                  params=p, lut=m.lut)
        t0 = mark("seed+search", t0)
        cand, ovf, n_drop = M.select_and_locate(
            m.fm, m.ssa, lo, hi, offs, sval, reads.shape[1], params=p)
        t0 = mark("select+locate", t0)
        ext = M.extend_candidates(m.fm, m.gwords, all_r, all_q, lens2, cand,
                                  params=p, genome=m.genome)
        t0 = mark(f"extend ({ext_k})", t0)
        ext["locate_dropped"] = n_drop
        ext["overflow"] = ovf.reshape(2, -1).any(0) | ext.pop(
            "cand_overflow")
        fwd = M.top2_finish(ext, jl, p)
        t0 = mark("top2+mapq", t0)
        res, walk = M.traceback_walk_batch(
            m.genome, m.n, jr, jl, jq, fwd["win_start"], fwd["strand"],
            params=p, active=fwd["aligned"])
        t0 = mark(f"traceback ({tb_k})+walk", t0)
        results = m._finish(reads, lens, qmat, fwd, res, walk)
        recs = m.to_sam_records(names, reads, lens, qmat, results)
        t0 = mark("host finish+SAM records", t0)
        assert len(recs) == len(names)
        rows.append(t)
    rows = rows[1:] or rows  # the first batch warms the allocator
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def phase_real_size(torch, np):
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads
    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    d = os.path.join(WORK, "chr20len")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    g = random_genome(CHR20_BP, seed=SEED)
    write_fasta(f"{d}/g.fa", [("chr20_random", g)])
    sim = simulate_reads(g, N_READS, 100, error_rate=0.02, indel_rate=0.005,
                         seed=SEED + 1)
    write_fastq(f"{d}/r.fq", [
        (f"r{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(N_READS)])
    write_fastq(f"{d}/r_cpu.fq", [
        (f"r{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(CPU_READS)])
    log(f"[real] {CHR20_BP} bp genome + {N_READS} reads made in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    build([f"{d}/g.fa", f"{d}/g.npz", "--sa-sample", "4", "--lut-k", "11"])
    build_s = time.perf_counter() - t0
    log(f"[real] build_index: {build_s:.1f}s")

    # the main path's run: launch counts from here on are the path's
    banded_dp.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mapr(["-x", f"{d}/g.npz", "-U", f"{d}/r.fq", "-S", f"{d}/gpu.sam",
          "--device", DEV, "--batch", "4096", "--stats",
          f"{d}/stats.json"])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    stats = json.load(open(f"{d}/stats.json"))
    recs = sam_records(f"{d}/gpu.sam")
    if len(recs) != N_READS:
        fail(f"{len(recs)} SAM records for {N_READS} reads")
    aligned = correct = 0
    for i, ln in enumerate(recs):
        f = ln.split("\t", 4)
        flag, pos = int(f[1]), int(f[3])
        if flag & 4:
            continue
        aligned += 1
        if (int(bool(flag & 16)) == int(sim["true_strand"][i])
                and abs(pos - 1 - int(sim["true_pos"][i])) <= 8):
            correct += 1
    frac_al = aligned / N_READS
    frac_ok = correct / max(aligned, 1)
    log(f"[real] map_reads --device cuda: {N_READS} reads in "
        f"{stats['map_s']:.2f}s = {stats['reads_per_s']:.0f} reads/s "
        f"(index load {stats['load_s']:.1f}s not counted); peak "
        f"{peak / 2**30:.2f} GiB; aligned {frac_al:.4f}, correct "
        f"{frac_ok:.4f} of aligned; escalated {stats['escalated']}, "
        f"locate_dropped {stats['locate_dropped']}; launches {launches}")
    if frac_al < 0.95 or frac_ok < 0.90:
        fail(f"accuracy bars missed: aligned {frac_al}, correct {frac_ok}")

    t0 = time.perf_counter()
    mapr(["-x", f"{d}/g.npz", "-U", f"{d}/r_cpu.fq", "-S", f"{d}/cpu.sam",
          "--device", "cpu", "--batch", "4096"])
    cpu_s = time.perf_counter() - t0
    cpu_recs = sam_records(f"{d}/cpu.sam")
    if cpu_recs != recs[:CPU_READS]:
        n_diff = sum(a != b for a, b in zip(cpu_recs, recs))
        fail(f"--device cpu SAM differs from --device cuda on the first "
             f"{CPU_READS} reads ({n_diff} records)")
    log(f"[real] first {CPU_READS} reads re-mapped with --device cpu: "
        f"identical SAM records ({cpu_s:.1f}s with the plain versions)")

    stages = stage_breakdown(torch, np, f"{d}/g.npz", f"{d}/r.fq")
    log("[real] one 4096-read batch, ms per stage (synchronised, median "
        "of 3): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    return {"build_s": build_s, "launches": launches, "peak_bytes": peak,
            "aligned": frac_al, "correct": frac_ok, "stats": stats,
            "cpu_subset_s": cpu_s, "stages_ms": stages}, g


def phase_long_reads(torch, np, g):
    """20 000 reads of 2 kb on the chr20-length index through map_reads
    --max-read-len 2048 --band 63 --batch 1024 --device cuda."""
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.utils.simulate import simulate_reads
    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    d = os.path.join(WORK, "chr20len")
    t0 = time.perf_counter()
    sim = simulate_reads(g, N_LONG, LONG_LEN, error_rate=0.02,
                         indel_rate=0.005, seed=SEED + 2)
    recs = [(f"l{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
            for i in range(N_LONG)]
    write_fastq(f"{d}/long.fq", recs)
    write_fastq(f"{d}/long_cpu.fq", recs[:LONG_CPU])
    log(f"[long] {N_LONG} reads of {LONG_LEN} bp made in "
        f"{time.perf_counter() - t0:.1f}s")
    flags = ["--max-read-len", "2048", "--band", str(LONG_W)]

    # the long-read path's run: launch counts from here on are its own
    banded_dp.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mapr(["-x", f"{d}/g.npz", "-U", f"{d}/long.fq", "-S", f"{d}/long.sam",
          "--device", DEV, "--batch", "1024", "--stats",
          f"{d}/long_stats.json", *flags])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    stats = json.load(open(f"{d}/long_stats.json"))
    out = sam_records(f"{d}/long.sam")
    if len(out) != N_LONG:
        fail(f"{len(out)} SAM records for {N_LONG} long reads")
    aligned = correct = 0
    for i, ln in enumerate(out):
        f = ln.split("\t", 4)
        flag, pos = int(f[1]), int(f[3])
        if flag & 4:
            continue
        aligned += 1
        if (int(bool(flag & 16)) == int(sim["true_strand"][i])
                and abs(pos - 1 - int(sim["true_pos"][i])) <= 40):
            correct += 1
    frac_al = aligned / N_LONG
    frac_ok = correct / max(aligned, 1)
    log(f"[long] map_reads --device cuda {' '.join(flags)} --batch 1024: "
        f"{N_LONG} reads in {stats['map_s']:.2f}s = "
        f"{stats['reads_per_s']:.0f} reads/s (index load "
        f"{stats['load_s']:.1f}s not counted); peak {peak / 2**30:.2f} GiB; "
        f"aligned {frac_al:.4f}, within 40 bp on the true strand "
        f"{frac_ok:.4f} of aligned; escalated {stats['escalated']}, "
        f"locate_dropped {stats['locate_dropped']}; launches {launches}")
    if launches["K4"] < 1:
        fail(f"the long-read run never launched K4: {launches}")
    if frac_al < 0.95 or frac_ok < 0.90:
        fail(f"long-read accuracy bars missed: aligned {frac_al}, correct "
             f"{frac_ok}")

    sams = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        mapr(["-x", f"{d}/g.npz", "-U", f"{d}/long_cpu.fq", "-S",
              f"{d}/long_{dev}.sam", "--device", dev, "--batch",
              str(LONG_CPU), *flags])
        sams[dev] = (sam_records(f"{d}/long_{dev}.sam"),
                     time.perf_counter() - t0)
    if sams[DEV][0] != sams["cpu"][0]:
        n_diff = sum(a != b for a, b in zip(sams[DEV][0], sams["cpu"][0]))
        fail(f"long reads: --device cpu SAM differs from --device cuda on "
             f"the first {LONG_CPU} reads ({n_diff} records)")
    log(f"[long] first {LONG_CPU} reads with --batch {LONG_CPU}: identical "
        f"SAM records under --device cuda ({sams[DEV][1]:.1f}s) and "
        f"--device cpu ({sams['cpu'][1]:.1f}s)")

    stages = stage_breakdown(torch, np, f"{d}/g.npz", f"{d}/long.fq",
                             batch=1024, max_len=2048, band_w=LONG_W)
    log("[long] one 1024-read batch, ms per stage (synchronised, median "
        "of 3): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    return {"launches": launches, "peak_bytes": peak, "aligned": frac_al,
            "correct": frac_ok, "stats": stats, "stages_ms": stages,
            "cuda_subset_s": sams[DEV][1], "cpu_subset_s": sams["cpu"][1]}


def main():
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "nvbio_tpu_torch")):
        fail("run from a checkout of the repository (nvbio_tpu_torch/ "
             "not found beside this script)")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    smi, mhz = phase_card(torch)
    torch.cuda.set_device(0)
    result = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "max_sm_mhz": mhz,
              "int32_peak": INT32_PEAK}
    try:
        result["build_s"] = phase_build()
        result["kernels"] = phase_kernels(torch, np)
        result["kernels"]["K4"] = phase_k4(torch, np)
        result["kernels"].update(phase_k5(torch, np))
        result["kernels"]["K6"] = phase_k6(torch, np)
        torch.cuda.empty_cache()
        result["sw_benchmark"] = phase_sw_benchmark(torch)
        result["tool_shapes"] = phase_tool_shapes(torch, np)
        torch.cuda.empty_cache()
        result["pass3"] = phase_pass3(torch, np)
        torch.cuda.empty_cache()
        result["wide_band"] = phase_wide_band(torch, np)
        result["bench_k1"] = phase_bench_k1(torch, np)
        torch.cuda.empty_cache()
        result["golden_launches"] = phase_golden(torch)
        result["real"], genome = phase_real_size(torch, np)
        torch.cuda.empty_cache()
        result["long"] = phase_long_reads(torch, np, genome)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_start
    if any(m in ("jax", "nvbio_tpu") or m.startswith(("jax.", "nvbio_tpu."))
           for m in sys.modules):
        fail("jax or the JAX package was imported")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "result.json"), "w") as f:
        json.dump(result, f, indent=1)

    paths = {"short-read run": result["real"]["launches"],
             "long-read run": result["long"]["launches"],
             "sw_benchmark --long": result["sw_benchmark"]["launches"],
             "pass 3": result["pass3"]["launches"]}
    csrc = "nvbio_tpu_torch/ops/csrc/"
    kernels = []
    # (name, source, replaces, the path whose run launches it)
    for name, src, replaces, path in (
            ("K1", "banded_gotoh.cu", "nvbio_tpu/ops/banded_dp.py:835",
             "sw_benchmark --long"),
            ("K2", "banded_gotoh.cu", "nvbio_tpu/ops/banded_dp.py:620",
             "short-read run"),
            ("K3", "banded_gotoh.cu", "nvbio_tpu/ops/banded_dp.py:528",
             "short-read run"),
            ("K4", "long_gotoh.cu", "nvbio_tpu/ops/long_dp.py:218",
             "long-read run"),
            ("K5", "wavefront_gotoh.cu", "nvbio_tpu/ops/wavefront_dp.py:349",
             "sw_benchmark --long"),
            ("K5_dirs", "wavefront_gotoh.cu",
             "nvbio_tpu/ops/wavefront_dp.py:321", "pass 3"),
            ("K6", "myers.cu", "nvbio_tpu/ops/myers_pallas.py:187",
             "sw_benchmark --long")):
        k = result["kernels"][name]
        n = paths[path][name]
        if n < 1:
            fail(f"the {path} never launched {name}: {paths[path]}")
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": None})
    log(f"[done] {result['seconds']:.0f}s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
