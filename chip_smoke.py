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
   --device cpu to identical SAM lines.

The last line is {"ok": true, "device": {...}}; the line before it
lists the ported kernels (K1-K4) as JSON, with the launches of the
path that runs each (K3, K2: the short-read run; K4: the long-read run;
K1 runs on neither: the paired-end rescue, not ported yet, uses it).
Bulk files go to .chip_smoke_work/ (removed at the end), a copy of the
numbers to result.json in OUT, with nvcc's ptxas report beside it.
Imports no JAX: a finder refuses it.
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


class _BlockJax:
    """Refuse any import of jax: the GPU machine has none, and the port
    must not need it."""

    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"chip_smoke: blocked import of {name}")
        return None


sys.meta_path.insert(0, _BlockJax())


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
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


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
        for name, kern, plain, c in (("K1", k1, p1, cells),
                                     ("K3", k3, p3, cells),
                                     ("K2", k2, p2, cells2)):
            ms, pms = cuda_ms(torch, kern, 10), cuda_ms(torch, plain, 2)
            out[name] = {"ms": ms, "plain_ms": pms,
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
        out = {"ms": ms, "plain_ms": pms, "gcups": cells / ms / 1e6,
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
        if counts != {"K1": 0, "K2": 0, "K3": 0, "K4": 3}:
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


def sam_records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def phase_golden(torch):
    from nvbio_tpu.io.fasta import write_fasta
    from nvbio_tpu.io.fastq import write_fastq
    from nvbio_tpu.utils.simulate import random_genome, simulate_reads
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
    from nvbio_tpu.io.sequence import ReadBatchIterator
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
    from nvbio_tpu.io.fasta import write_fasta
    from nvbio_tpu.io.fastq import write_fastq
    from nvbio_tpu.utils.simulate import random_genome, simulate_reads
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
    from nvbio_tpu.io.fastq import write_fastq
    from nvbio_tpu.utils.simulate import simulate_reads
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

    smi = phase_card(torch)
    torch.cuda.set_device(0)
    result = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    try:
        result["build_s"] = phase_build()
        result["kernels"] = phase_kernels(torch, np)
        result["kernels"]["K4"] = phase_k4(torch, np)
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
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "result.json"), "w") as f:
        json.dump(result, f, indent=1)

    short, long_ = result["real"]["launches"], result["long"]["launches"]
    csrc = "nvbio_tpu_torch/ops/csrc/"
    kernels = []
    # (name, source, replaces, launches on the path that runs it)
    for name, src, replaces, n in (
            ("K1", "banded_gotoh.cu", "nvbio_tpu/ops/banded_dp.py:761",
             short["K1"]),
            ("K2", "banded_gotoh.cu", "nvbio_tpu/ops/banded_dp.py:620",
             short["K2"]),
            ("K3", "banded_gotoh.cu", "nvbio_tpu/ops/banded_dp.py:528",
             short["K3"]),
            ("K4", "long_gotoh.cu", "nvbio_tpu/ops/long_dp.py:218",
             long_["K4"])):
        k = result["kernels"][name]
        if name != "K1" and n < 1:
            fail(f"the path never launched {name}: short {short}, long "
                 f"{long_}")
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"]})
    log(f"[off the paths] K1: no single-end path launches it (the "
        f"paired-end rescue does); {result['bench_k1']['gcups']} GCUPS at "
        "bench.py's shape")
    log(f"[done] {result['seconds']:.0f}s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
