#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nvbio_tpu_torch) on one GPU.

    python3 chip_smoke.py                   # every phase, as below
    python3 chip_smoke.py --times ROOT      # the kernel phases (3, 4, 4b,
                                            # 4c, 9, 10, 10b, 14) on ROOT's
                                            # package
    python3 chip_smoke.py --turns PARENT    # --times on PARENT and on this
                                            # checkout in turns (parent,
                                            # this, this, parent)
    python3 chip_smoke.py --times ROOT --rows K1,K3_path
                                            # only the kernel phases that
                                            # time these rows (timed_rows'
                                            # names); --turns takes it too

Phases, each of which raises (exit code != 0, no result line) on any
failure:

1. the card: nvidia-smi name and power limit, torch and CUDA versions;
2. the build: nvcc compiles the kernels from nvbio_tpu_torch/ops/csrc
   (one process per source, started together); the registers, shared
   bytes and spills of every instantiation of the sub-warp group kernel
   (K1-K3, K4 up to 128 cells), of K7's group kernel on halfword pairs
   (every tier; the compare form at the tiers up to 64 cells), of K5's
   matrix full-band tier
   and of
   K5's formula banded tier from ptxas, the two K5 tiers with the warps
   an SM they keep resident;
3. K1, K2, K3 against their plain PyTorch versions on the card, bit for
   bit, at the extension batch's shape (NB = 32767 windows, 128-row
   patterns, band_w = 15), for all three alignment types (K1 and K3 also
   with scores past a signed byte); K2's walk outputs too; CUDA-event
   times of kernel and plain version (K2 and K3 here are their
   throughput rows); K1 at bench.py's shape (2 097 152 x 100 bp x band
   31) and on an eighth of it at band_w 31 (63 cells, K1's widest);
4. K4 against its plain versions at the long-read path's shapes
   (score-only NB = 8192, directions NB = 1024; Lp = 2016, band_w = 63),
   for all three alignment types, flags and walks included; times;
4b. K2, K3 and K4 at the shapes their paths launch them: K2 over the
   4096 winners of a short-read batch (128 rows, band_w 15), K3 over a
   batch's extension slots (32 768 x 128, band_w 15, the first 5 000
   with a pattern, the rest zero-length pad lanes; checked against the
   real calls in phase 7) and K4 at the paired-end rescue's chunked call
   (rescue_shape(): 14 336 x 128, Lt 199, band_w 63, checked against
   the real call in phase 16), all three types against the plain
   versions (flags and walks too; K3 also with scores past a signed
   byte), times
   with the calls queued and as issued (launch cost included), bounds,
   and the block shape with the warps an SM the call keeps resident
   (occupancy(): sm_90's rules over the ptxas registers and shared
   bytes);
4c. K4's score tier past 128 cells at the PE --local rescue's call
   (1 024 x 128, Lt 1 188, band_w 530, rescue_wide_inputs), LOCAL (row
   K4_wide) and SEMI_GLOBAL (row K4_wide_semi), and at the same call on
   150 bp mates (1 024 x 160, Lt 1 220, LOCAL, row K4_wide_150), each
   call asserted to take wide_plan's tier (the column sweep, at 4 and 8
   rows a lane) as the kernel library reports it, against the plain
   version bit for bit; times queued and as issued, bound, block shape
   and warps an SM;
5. the wide-band repair: K1-, K2- and K3-shaped calls at band_w = 63
   (Lp = 128, NB = 32767) launch K4 and equal the plain versions;
6. the golden dataset through build_index + map_reads --device cuda:
   SAM identical to tests/data/golden_se.sam.gz (ignoring @PG); and
   with -S *.bam under --device cuda and --device cpu: BGZF BAM whose
   decompressed bytes are identical (ignoring @PG);
7. the short-read path at real size: a seeded random genome of GRCh38
   chr20's length, 100 000 simulated 100 bp reads, build_index then
   map_reads --device cuda --batch 4096 with the launch counts reset
   just before; accuracy bars, throughput, peak memory, a per-stage
   breakdown of one batch (with the shapes of the extension's K3 calls
   and their lanes with a pattern), and the first 4096 reads re-mapped
   with --device cpu to identical SAM lines;
7b. index construction on the card (phase_sufsort): build_index
   --algorithm device --device cuda at E. coli K-12's length (4 641 652
   bp, whole-text device prefix doubling) against --algorithm sais,
   every .npz array equal; build_index --algorithm device --device-occ
   on the chr20-length genome (the bucketed sort and the device occ
   tables) against phase 7's SA-IS g.npz; suffix_array_bucketed on a
   16 Mbp repeat-structured text (at least one compacted doubling
   round) against SA-IS; set_bwt --device cuda of phase 7's 100 000
   reads against --device cpu, with the A/C/G/T/$ counts the reads
   give; host-clock seconds and Mbp/s (Mbases/s) beside SA-IS's on the
   same texts, and peak device bytes;
8. the long-read path at real size: 20 000 simulated 2 kb reads on the
   same index, map_reads --max-read-len 2048 --band 63 --batch 1024
   --device cuda with the counts reset just before; K4 launched,
   accuracy bars (40 bp window), throughput, peak memory, per-stage
   breakdown, and the first 128 reads mapped under --device cuda and
   --device cpu to identical SAM lines;
9. K5 against its plain versions at sw_benchmark's wide shape (128 x
   4000 bp, band_w 2000): score-only for all three alignment types (N
   symbols, ragged and zero lengths, a GLOBAL goal outside the band),
   each call asserted to have taken the banded column-sweep tier (where
   the package has it) and the diagonal score kernel, which takes
   patterns past the tier's reach, held to the same plain result by its
   C entry, with flags on 8 lanes (every flag byte, the diagonal
   kernel), the device walk over the kernel's flags against the host
   walk; times and GCUPS; both score kernels against the plain version
   and timed at narrower bands and other shapes (K5_THRESHOLD_SHAPES);
10. K6 against its plain version at MYERS_SHAPES: 2^19 x 100 bp (the
   thread tier), 8192 x 1000 bp (32 words) and long_tier_bench's 128 x 8
   kb, 128 x 16 kb and 64 x 32 kb (the warp tier; held on 8 lanes of
   1 024 columns with plens on word, lane and strip edges and poly-A
   runs), GLOBAL and SEMI_GLOBAL, and SEMI_GLOBAL on every lane of the
   full shape (the plain version's timed call), each shape driven once
   at full size with the counts reset just before and its tier asserted
   (the warp tier past 8 words, launches on it counted by
   myers.warp_launches);
   times, GCUPS, the plain version's time (one call at the long shapes),
   the warp tier's block, registers and warps an SM;
10b. K5's matrix mode at protein_sw's shapes (phase 24's seeded
   proteins, band_w = max(Lq, Lt)): the strided 2 048-pair subset
   against its plain version in all three alignment types (row
   K5_matrix) and the whole 131 072-pair batch (row K5_matrix_full),
   timed in LOCAL, with the full-band tier's launches, warps an SM,
   grid and scratch bytes; a banded matrix call (band_w 64) on the
   diagonal kernel against its plain version;
11. sw_benchmark --device cuda --long at its defaults (the JAX tool's
   TPU sizes) with the counts reset just before: K1, K4, K5 and K6
   launched, every K5 call (gotoh_wide's and wide_cigar's pass 1) on the
   banded tier; its JSON rows recorded;
12. K4 at the shapes sw_benchmark gives it, on the tool's own batches:
   score-only at 1024 x 10 000 bp, band_w 63, and with flags and walks
   on wide_cigar's pass-2 call (128 x 4000 bp, the certificate's band),
   bit-identical to the plain versions; wide_cigar's 128 CIGARs
   re-scored, its first 4 lanes equal to a CPU run of the same lanes;
13. pass 3 of the wide-band CIGAR: wide_band_cigar_batch on 8 lanes of
   4000 bp at band_w 2000, each with one planted deletion past the 767
   band ladder (tests/test_wide_cigar.py's forced-gap scheme), with the
   counts reset just before: K5 with flags launched, every lane has a
   CIGAR that re-scores to its score and holds its planted D run;
14. the int16 opt-in: banded_score(compute_dtype="int16") at
   K7_SHAPES: K1's row shape (32 767 x 128, band_w 15), a mid band (the
   same at band_w 63, 127 cells), a wide band inside the int16 guard
   (8192 x 16, band_w 700: 717 live cells) and Lp 128 at band_w 7 and
   31, all three types, with the counts reset just before: only K7
   launched, bit-identical to its plain version; CUDA-event times of K7,
   of the int32 call's kernel at the same shape (K1, K4 past 64 cells;
   in turns) and of the plain version, each shape's group tier (the C
   entry k7_plan's) and warps an SM (the registers and spills of every
   K7 tier are phase 2's);
15. the golden paired-end dataset through map_reads -1/-2 --device cuda:
   SAM identical to tests/data/golden_pe.sam.gz (ignoring @PG), K2, K3
   and K4 (the rescue) launched;
16. the paired-end path at real size on the chr20-length index: 50 000
   pairs of 2 x 100 bp from simulate_pairs(insert 280 +- 25, 2% errors),
   5% of them with every 12th base of mate 2 flipped so that rescue
   places them, map_reads -1/-2 --batch 4096 --device cuda with the
   counts reset just before: K2, K3 and K4 launched, pairs rescued,
   accuracy bars, pairs/s, proper and rescued shares, peak memory, a
   per-stage breakdown of one batch (with the shapes of the rescue's DP
   calls), and the first 128 pairs mapped under --device cuda and
   --device cpu to identical SAM lines;
17-20. the alignment modes on the chr20-length index, each run with the
   counts reset just before and read just after, and each kernel it
   launches held against its plain version on the arguments of a call
   the run made (capture(), hold_call()): --local over the 100 000 reads
   (K3 and K2 in LOCAL; accuracy against the origin less the leading
   soft clip; the first 4096 under --device cpu too); -N 1 over 5
   batches (the K3 calls' shapes and live lanes; 1024 reads under both
   devices; 4096 planted reads with one substitution in every seed,
   none aligned by -N 0, at their origin under -N 1); -a --max-alns 8
   over the same reads (K2 over 8 x 4096 winners; 1024 reads under both
   devices; a planted duplicate whose every read reports both loci,
   secondaries with FLAG 0x100); PE --local over 4 batches of phase
   16's pairs (K4 at the window-wide rescue band, band_w 530, every
   launch asserted on the column sweep; 128 pairs under both devices);
21. map_reads' input and output options on the same index (after the
   paired-end phases, whose pairs it reuses): the short-read run's first
   20 480 reads rewritten as Phred+64 through --phred64 --un (gzip) --al
   --rg-id --rg --stats --html with the counts reset just before (K2 and
   K3 launched, a K3 call held against its plain version), its records
   with RG:Z stripped equal to a plain Phred+33 run's in the same
   process, the @RG line, --un/--al equal to the unmapped/mapped records,
   the stats and the HTML report's sections; PE --un/--al/--rg-id on the
   first 4096 pairs (/1 and /2 counts, K4 launched at the rescue);
   --resume after 3 batches and --num-shards 2 + sam_merge, each equal to
   the single run; the flag set on 1024 reads under --device cuda and
   --device cpu (SAM, --un/--al bytes, non-timing stats identical); and
   an --xprof trace of one 4096-read batch (kernel events, and whether
   the hand kernels' names are among them);
22. the sharded index on the same genome: build_index --shard-bp
   16777216 --shard-overlap 1024 --procs 4 (4 shards), the device bytes
   of the loaded sharded and unsharded mappers, then map_reads on the
   manifest over the short-read run's 100 000 reads and the paired-end
   run's first 16 384 pairs, each with the counts reset just before (K3
   launched once a shard and batch, K2 once a batch, K4 at the rescue):
   no read differs from the unsharded run in (aligned, POS, strand,
   CIGAR, AS, MD, NM), each pair that differs is proper with a summed AS
   no lower (the rescue-anchor divergence of the sharded PE mapper),
   with the unsharded index's pairs/s on the same pairs before and
   after; a per-stage breakdown of one sharded SE batch; CUDA SAM = CPU
   SAM on 1 024 reads and 256 pairs; K3, K2 and K4 held against their
   plain versions on calls the sharded runs made;
23. the MEM and q-gram mappers on the same index (after the -a phase):
   mem_map and then qmap --device cuda --batch 4096 --stats over the
   short-read run's 100 000 reads, each with the counts reset just
   before and read just after: K2 and K3 launched and held against their
   plain versions on a call the run made, the short-read accuracy bars,
   reads/s, peak memory, the q-gram index's build seconds, 1024 reads
   under --device cuda and --device cpu to identical SAM lines, and a
   per-stage breakdown of one mem_map batch (SMEM search, locate,
   extension, top-2, traceback, host finish);
24. protein SW (after the long-read run): protein_sw --device cuda over
   64 query proteins against 2 048 targets of 50-1000 residues (half the
   queries planted as ~30 % substituted copies in targets; BLOSUM62 at
   10/1) with the counts reset just before: K5_matrix launched and
   nothing else, every call through its full-band tier, every planted
   pair above its query's other pairs; K5_matrix against its plain
   version on a strided 2 048-alignment subset of the all-pairs batch
   (band_w = max(Lq, Lt)), the whole batch against the CLI's scores and
   against its plain version (run in 16 384-pair calls and timed; the
   kernel's times are phase 10b's); the CLI under --device cuda and
   --device cpu on an 8 x 64 subset, TSV bytes equal;
25. the wavelet-tree protein FM-index over an 11 M-residue text (host
   build timed): 65 536 8-mer searches on the card equal to the CPU's
   on the same index, the planted ones holding their text counts;
26. the read corrector at E. coli's length, 30x of 100 bp reads with 1 %
   substitutions: passes 1 and 2 at --log2-slots 24 and 28, rounds 1
   and 2, with the per-base error before and after against the
   simulated truth and reads/s; correct_reads --rounds 2 on 50 000
   reads under --device cuda and --device cpu, FASTQ bytes equal;
27. BWA interop at E. coli's length in two contigs with N runs:
   build_index, bwa_export --reverse, bwa_import (the .bwt cross-check
   passed), the imported .npz equal to the direct build's, and map_reads
   --device cuda of 20 000 reads against both giving the same SAM;
28. self_test --device cuda at full size (1 Mbp, 2 000 reads; after the
   kernel phases): its five checks ok, K1 against its plain version
   among them, the native CIGAR/MD builder (not the Python fallback)
   finishing every batch;
29. the shard-per-device mesh (after the sharded phase, on its 4-shard
   manifest): MeshShardedMapper and MeshPairedShardedMapper with shard k
   on cuda:(k mod device_count) beside the sequential sharded mappers in
   the same process, 16 384 reads, 4 096 pairs and -a --max-alns 4 on
   1 024 reads, each after a warm-up batch, in turns (sequential, mesh,
   mesh, sequential), every result equal;
   launch counts, reads/s and pairs/s of both schedules, each shard's
   device and bytes; with fewer cards than shards, map_reads --mesh on
   stops with the reference's message;
30. fm_server serving the chr20-length g.npz on the card in a thread:
   an SE request of 16 384 reads and a PE request of 4 096 pairs, each
   twice (cold, warm), each SAM equal to map_reads' at the server's
   settings (@PG masked); attach seconds, reads/s and pairs/s.

The last line is {"ok": true, "device": {...}}; the line before it
lists the ported kernels (K1-K7, K4 also as its score tier past 128
cells, K4_wide, K5 as its score, its flag and its matrix-score entry
points, the last also as its full-band tier) as JSON, with the launches
of the path that runs each (K2, K3: the short-read run; K4: the
long-read run; K4_wide: the PE --local run's launches on the sweep;
K1, K5, K6: sw_benchmark; K6 on the warp tier, K6_32w and the long
rows: the Myers phase's full-size calls; K5 with
flags: the pass-3 run; K7: the int16 opt-in phase; K5_matrix and
K5_matrix_full: the protein_sw run; the modes' runs must launch theirs
too), the time
and plain time at the phase shapes (K2 and K3 at the short-read path's
calls, phase 4b), and the least time the card could
take for the same call (bound_ms: int32 operations over 132 SMs x 64
lanes x the max SM clock, K7's int16 operations over twice that, or
bytes over 3.35 TB/s, whichever is larger; the DP kernels' operations
over the in-band cells the call needs, band_cells, banded Gotoh's as the
least instruction count, GOTOH_OPS).  Bulk files go to
.chip_smoke_work/ (removed at the end), a copy of the numbers to
result.json in OUT, with nvcc's ptxas report beside it.  Imports no JAX
and nothing of nvbio_tpu: a finder refuses both.
"""

from __future__ import annotations

import gzip
import inspect
import json
import os
import shutil
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke_work")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
CHR20_BP = 64_444_167  # GRCh38 chr20 (BASELINE config 3), random sequence
N_READS = 100_000
CPU_READS = 4096
SEED = 20
NB, LP, BAND_W = 32_767, 128, 15  # extension batch of the main path
# the main path's K2 call: the 4096 winners of a short-read batch
# (mapper.traceback_walk_windows), 100 bp reads bucketed to 128 rows
K2_PATH_NB = 4_096
# the main path's K3 call: a 4096-read batch's extension slots
# (mapper.extend_candidates: 2 strands x 16 candidates x extend_frac
# 0.25 = 32 768 lanes, Lp 128, Lt 158, band_w 15), of which only the
# kept candidates, compacted to the front, have a pattern (plen > 0);
# phase_real_size reads the real calls and checks both against these
K3_PATH_NB, K3_PATH_LIVE = 32_768, 5_000
DEV = "cuda"
BENCH_NB, BENCH_LP = 2_097_152, 100  # bench.py:43-56
# the long-read path: 1024-read chunks of 2 kb reads (bucketed to 2016)
# at --band 63; their extension batch is 2 * 1024 * 16 * 0.25 lanes
LONG_NB, LONG_DIRS_NB, LONG_LP, LONG_W = 8_192, 1_024, 2_016, 63
# K4's score tier past 128 cells at the PE --local rescue's call
# (paired._rescue with no chunk plan: 1 024 mates, 100 bp bucketed to 128
# rows, band_w = maxins + 2 * band_w = 530, Lt = 128 + 2 * 530), and on
# 150 bp mates (bucketed to 160 rows: the sweep at 8 rows a lane)
K4W_NB, K4W_LP, K4W_W = 1_024, 128, 530
K4W_LP150 = 160
N_LONG, LONG_LEN, LONG_CPU = 20_000, 2_000, 128
# sw_benchmark's wide batch (nvbio_tpu/tools/sw_benchmark.py:153-162):
# 128 lanes of 4000 bp at band_w 2000; K5's flags are checked on 8
WIDE_NB, WIDE_DIRS_NB, WIDE_LP, WIDE_W = 128, 8, 4_000, 2_000
# Myers by row name: sw_benchmark's 2^19 x 100 bp (the thread tier), a
# 32-word pattern length (sw_benchmark --read-len 1000's W) and
# benchsuite/long_tier_bench.py's long patterns (Lt = Lp + 1 024, its
# "32 kb+" rows) on the warp tier
MYERS_SHAPES = {"K6": (1 << 19, 100, 130), "K6_32w": (8_192, 1_000, 1_060),
                "K6_8k": (128, 8_192, 9_216),
                "K6_16k": (128, 16_384, 17_408),
                "K6_32k": (64, 32_768, 33_792)}
# patterns past MYERS_HOLD_LP symbols are held on MYERS_HOLD lanes of
# MYERS_HOLD_LT text columns (the plain loop takes ~20 s a call at
# 33 792 columns), with ragged plens on word, lane and strip edges; their
# plain version is timed on one call at the full shape, which holds the
# kernel's SEMI_GLOBAL result on every lane and column
MYERS_HOLD_LP, MYERS_HOLD, MYERS_HOLD_LT = 1_000, 8, 1_024
# K7's shapes: the extension batch's row (band_w 15), a mid band (127
# cells: 100 bp windows at the long-read path's band_w 63, inside the
# int16 guard), a wide band at Lp 16 (1401 cells, 717 of them live), and
# Lp 128 at band_w 7 and 31, where K7 is timed against the parent's
# kernel too (the old register tier's 16- and 64-cell bands)
K7_WIDE_NB, K7_WIDE_LP, K7_WIDE_W = 8_192, 16, 700
K7_SHAPES = {"row": (NB, LP, BAND_W), "mid": (NB, LP, 63),
             "wide": (K7_WIDE_NB, K7_WIDE_LP, K7_WIDE_W),
             "w7": (NB, LP, 7), "w31": (NB, LP, 31)}
#: the timed_rows name of each K7 shape
K7_ROWS = {"row": "K7", "mid": "K7_mid", "wide": "K7_wide", "w7": "K7_w7",
           "w31": "K7_w31"}
# the paired-end run: pairs, the share with a rescue-only mate 2, the
# pairs mapped on both devices
N_PAIRS, PE_RESCUE_SHARE, PE_CPU = 50_000, 0.05, 128
# the alignment modes' runs on the same index: batches of 4096 of the
# short-read run's reads under -N 1 and -a, the reads of those mapped
# under both devices, and the pairs of the paired-end run under --local
N_MODE_BATCHES, MODE_SUB, N_PE_LOCAL = 5, 1024, 4 * 4096
# the input/output options' runs: the short-read run's first reads (and a
# cut after 3 batches for --resume), the paired-end run's first pairs
IO_SE, IO_CUT, IO_PE = 5 * 4096, 3 * 4096, 4096
# the sharded run: build_index --shard-bp/--shard-overlap/--procs on the
# chr20-length genome (4 shards), the paired-end run's first pairs, and
# the reads and pairs mapped under both devices
SHARD_BP, SHARD_OVERLAP, SHARD_PROCS = 16_777_216, 1024, 4
N_SHARD_PAIRS, SHARD_CPU_READS, SHARD_CPU_PAIRS = 4 * 4096, 1024, 256
# the one-device sharded mapper whatever the host's device count
MESH_OFF = ["--mesh", "off"]
# the suffix-sort phase: a seeded random genome of E. coli K-12 MG1655's
# length (BASELINE configs 1-2; whole-text device doubling), and a
# repeat-structured text (the bucketed sort's compacted doubling)
ECOLI_BP, REPEATS_BP = 4_641_652, 16_000_000
# protein_sw: query and target proteins of 50-1000 residues (the bulk of
# UniProtKB), all pairs, and the strided subset K5_matrix is held on
PROT_Q, PROT_T, PROT_MIN, PROT_MAX, PROT_HOLD = 64, 2_048, 50, 1_000, 2_048
# pairs a call of the plain version over the whole batch takes
PROT_PLAIN_CHUNK = 16_384
# the protein FM-index: a text of about a human proteome's total length,
# and the 8-mer searches on it
WFM_N, WFM_SEARCHES = 11_000_000, 65_536
# the read corrector: coverage of the E. coli-length genome, the batch of
# its library run, the sketch sized to that many k-mers (2^28 slots,
# ~1.8 increments a slot against ~29 at the CLI's 2^24), the reads of
# the CLI's cuda = cpu run
CORR_COV, CORR_BATCH, CORR_BIG_SLOTS, CORR_CLI_READS = 30, 65_536, 28, 50_000
# BWA interop: reads mapped against the imported and the direct index
BWA_READS = 20_000
# fm_server on the chr20-length g.npz: the short-read run's first reads
# and the paired-end run's first pairs, a request each (twice); the
# server's MapperParams default seed interval, passed to map_reads too
SRV_SE, SRV_PAIRS, SRV_INTERVAL = 4 * 4096, 4096, "11"
# the shard-per-device mesh on the sharded phase's 4 shards: the reads,
# the pairs and the -a reads (--max-alns 4) it maps beside the
# sequential ShardedMapper
MESH_SE, MESH_PAIRS, MESH_ALL, MESH_ALNS = 4 * 4096, 4096, 1024, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM, N_SMS = 64, 132
# int32 operations per cell of banded Gotoh (K1-K5, K7), counted as the
# least instruction count on sm_90a, where a byte-table lookup (prmt) and
# each DPX form (max(a + b, c), max3) is one instruction: the
# substitution 1 (prmt into the row's table), Hdiag 1, F 2 (H_up - (fo +
# fe), then max(F_up - fe, that)), E 2 (the same over the row), Hhat 1,
# H 1, masking and sink 2; flags add the H source (2 compares, 2
# selects), the E/F open bits (2 compares) and packing (2 shifts/ors).
# K7 does these on int16 pairs, two cells an instruction.
GOTOH_OPS, GOTOH_FLAG_OPS = 10, 18
# the yardstick of the earlier records (15, 23), where the substitution
# took 4 (two compares, two selects), F and E 3 each: every row keeps
# its share of it beside the new one, so shares compare across records
YARD_OPS, YARD_FLAG_OPS = 15, 23
# Myers (K6), per word of ceil(plen / 32) and text column < tlen, as the
# least instruction count on sm_90a, where any function of three words
# is one LOP3, a shift with the carried-in top bit one funnel shift
# (SHF) and an add with carry in and out one IADD3: Peq select 1, xv =
# eq | vn 1, eq & vp 1, the add with carry 1, xh = (sum ^ vp) | eq 1,
# ph = vn | ~(xh | vp) 1, mh = vp & xh 1, the two shifts with carry 2,
# VP = mh' | ~(xv | ph') 1, VN = ph' & xv 1; per column: the end bits 2,
# the distance 1 (d + ph bit - mh bit, one IADD3), the best distance and
# its column 3.  The kernel's masks to plen bits are not counted: bits
# above the end bit never reach it (adds carry upward, shifts go left),
# so the function does not need them.
MYERS_WORD_OPS, MYERS_COL_OPS = 11, 6
# the yardstick of the earlier records (21, 7), one operation for each
# two-input operation: every K6 row keeps its share of it beside the new
MYERS_YARD_WORD_OPS, MYERS_YARD_COL_OPS = 21, 7


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
#: group_ptxas of the build, set by phase_build (None for a cached build
#: or a checkout whose builder does not report by source)
GROUP_TIERS = None
#: k5_full_ptxas of the build with the warps an SM each keeps resident,
#: set by phase_build (empty for a cached build or a package without the
#: tier)
K5_FULL_BUILD = []
#: the same for the formula score's banded tier (k5_band_kernel)
K5_BAND_BUILD = []
#: and for the flag entry point's tier (k5_band_dirs_kernel)
K5_DIRS_BUILD = []
#: k7_ptxas of the build (empty for a cached build or a package without
#: K7's group kernel)
K7_BUILD = []
#: k4_sweep_ptxas of the build (empty for a cached build or a package
#: without K4's sweep)
K4_SWEEP_BUILD = []
#: k6_ptxas of the build (empty for a cached build or a package without
#: K6's warp tier)
K6_BUILD = []


def bound(ops, nbytes, per_lane=1):
    """(bound_ms, bound_by): the least time the card could take for
    ``ops`` operations and ``nbytes`` bytes moved; ``per_lane``
    operations a 32-bit lane does at once (2 for int16 pairs)."""
    t_ops = ops / (INT32_PEAK * per_lane)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def gotoh_bound(cells, nbytes, dirs=False, per_lane=1):
    """(bound_ms, bound_by, yard_bound_ms) of a banded Gotoh call over
    ``cells`` needed cells: GOTOH_OPS (GOTOH_FLAG_OPS with flags) a cell,
    and the same at the earlier records' yardstick."""
    bms, by = bound(cells * (GOTOH_FLAG_OPS if dirs else GOTOH_OPS), nbytes,
                    per_lane)
    yard = bound(cells * (YARD_FLAG_OPS if dirs else YARD_OPS), nbytes,
                 per_lane)[0]
    return bms, by, yard


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
    global GROUP_TIERS
    tiers = None
    if _build.build_info is not None:
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
            f.write(_build.build_info["ptxas"])
        # (a parent checkout's builder of a --turns run has no such key)
        tiers = group_ptxas(_build.build_info.get("ptxas_by_source", {}))
        for t in tiers:
            log(f"[build] group tier G {t['G']} x CPT {t['CPT']}, "
                f"{['GLOBAL', 'SEMI_GLOBAL', 'LOCAL'][t['atype']]}"
                f"{', packed' if t['packed'] else ''}"
                f"{', flags' if t['dirs'] else ''}"
                f"{'' if t['byte_table'] else ', generic scores'} "
                f"({t['source']}): "
                f"{t['registers']} registers, {t['smem']} B shared, spill "
                f"stores {t['spill_stores']} B, loads {t['spill_loads']} B")
    GROUP_TIERS = tiers
    if _build.build_info is not None:
        full = k5_full_ptxas(_build.build_info.get("ptxas_by_source", {})
                             .get("wavefront_gotoh.cu", ""))
        lib = _build.library()
        for t in full:
            t["warps_per_sm"] = lib.k5_full_warps_per_sm(t["atype"])
            log(f"[build] K5 matrix full-band tier, "
                f"{['GLOBAL', 'SEMI_GLOBAL', 'LOCAL'][t['atype']]}: "
                f"{t.get('registers')} registers, {t.get('smem')} B static "
                f"shared, spill stores {t.get('spill_stores')} B, loads "
                f"{t.get('spill_loads')} B; {t['warps_per_sm']} warps an "
                "SM resident")
        K5_FULL_BUILD[:] = full
        band = k5_full_ptxas(_build.build_info.get("ptxas_by_source", {})
                             .get("wavefront_gotoh.cu", ""), "k5_band_kernel")
        for t in band:
            t["warps_per_sm"] = (lib.k5_band_warps_per_sm(t["atype"], WIDE_LP)
                                 if t["max_warps"] == 16 else
                                 lib.k5_band_warps_per_sm(t["atype"], 8192))
            log(f"[build] K5 banded tier ({t['max_warps']}-warp blocks), "
                f"{['GLOBAL', 'SEMI_GLOBAL', 'LOCAL'][t['atype']]}: "
                f"{t.get('registers')} registers, {t.get('smem')} B static "
                f"shared, spill stores {t.get('spill_stores')} B, loads "
                f"{t.get('spill_loads')} B; {t['warps_per_sm']} warps an SM "
                f"resident at Lp {WIDE_LP if t['max_warps'] == 16 else 8192}")
        K5_BAND_BUILD[:] = band
        dirs = k5_full_ptxas(_build.build_info.get("ptxas_by_source", {})
                             .get("wavefront_gotoh.cu", ""),
                             "k5_band_dirs_kernel")
        for t in dirs:
            # a call whose grid takes the instantiation: pass 3's (clusters
            # of 4-warp blocks), one of K5's score batch (a 16-warp block an
            # alignment) and one whose 32-warp blocks take 9 000 rows in
            # passes
            nb, lp = {4: (WIDE_DIRS_NB, WIDE_LP), 16: (WIDE_NB, WIDE_LP),
                      32: (1024, 9000)}[t["max_warps"]]
            t["warps_per_sm"] = lib.k5_band_dirs_warps_per_sm(t["atype"], nb,
                                                              lp)
            log(f"[build] K5 flag tier ({t['max_warps']}-warp blocks), "
                f"{['GLOBAL', 'SEMI_GLOBAL', 'LOCAL'][t['atype']]}: "
                f"{t.get('registers')} registers, {t.get('smem')} B static "
                f"shared, spill stores {t.get('spill_stores')} B, loads "
                f"{t.get('spill_loads')} B; {t['warps_per_sm']} warps an SM "
                f"resident at {nb} x {lp}")
        K5_DIRS_BUILD[:] = dirs
        sweep = k4_sweep_ptxas(_build.build_info.get("ptxas_by_source", {})
                               .get("long_gotoh.cu", ""))
        for t in sweep:
            log(f"[build] K4 sweep, {t['rpl']} rows a lane, "
                f"{['GLOBAL', 'SEMI_GLOBAL', 'LOCAL'][t['atype']]}"
                f"{', packed' if t['packed'] else ''}"
                f"{'' if t['byte_table'] else ', generic scores'}: "
                f"{t.get('registers')} registers, spill stores "
                f"{t.get('spill_stores')} B, loads {t.get('spill_loads')} B")
        K4_SWEEP_BUILD[:] = sweep
        K6_BUILD[:] = k6_ptxas(_build.build_info.get("ptxas_by_source", {})
                               .get("myers.cu", ""))
        for t in K6_BUILD:
            log(f"[build] K6 warp tier, {t['k']} words a lane, "
                f"{'GLOBAL' if t['global'] else 'SEMI_GLOBAL'}: "
                f"{t.get('registers')} registers, {t.get('smem')} B shared,"
                f" spill stores {t.get('spill_stores')} B, loads "
                f"{t.get('spill_loads')} B")
        K7_BUILD[:] = k7_ptxas(_build.build_info.get("ptxas_by_source", {})
                               .get("banded_gotoh16.cu", ""))
        for t in K7_BUILD:
            log(f"[build] K7 tier G {t['G']} x CPT {t['CPT']}, "
                f"{['GLOBAL', 'SEMI_GLOBAL', 'LOCAL'][t['atype']]}"
                f"{'' if t['byte_table'] else ', compare form'}, "
                f"{t['pinned_cells']} pinned cells a lane: "
                f"{t.get('registers')} registers, {t.get('smem')} B shared, "
                f"spill stores {t.get('spill_stores')} B, loads "
                f"{t.get('spill_loads')} B")
    return secs, tiers


def k4_sweep_ptxas(text):
    """Registers and spills of each instantiation of K4's column sweep
    (k4_sweep_kernel<R, ATYPE, PACKED, LUT>) from nvcc's ptxas report of
    long_gotoh.cu."""
    import re

    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            g = re.search(r"k4_sweep_kernelILi(\d+)ELi(\d)ELb([01])"
                          r"ELb([01])E", m.group(1))
            cur = None if not g else {
                "rpl": int(g[1]), "atype": int(g[2]),
                "packed": g[3] == "1", "byte_table": g[4] == "1"}
            if cur:
                out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    return out


def k6_ptxas(text):
    """Registers, shared bytes and spills of each instantiation of K6's
    warp tier (k6_warp_kernel<K, GLOBAL>) from nvcc's ptxas report of
    myers.cu."""
    import re

    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            g = re.search(r"k6_warp_kernelILi(\d+)ELb([01])E", m.group(1))
            cur = None if not g else {"k": int(g[1]), "global": g[2] == "1"}
            if cur:
                out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m[1]) if m else 0
    return out


def k6_occupancy(nb, lp):
    """The tier a K6 call of this shape takes, as the C entry k6_plan
    reports it, and on the warp tier its words a lane, strips, warps a
    block, grid, the registers of its SEMI_GLOBAL instantiation (phase 2)
    and the warps an SM it keeps resident (sm_blocks) and those this
    call's grid fills; None for a package without the plan (the parent of
    a --turns run)."""
    import ctypes

    from nvbio_tpu_torch.ops import _build, myers

    if not hasattr(myers, "myers_plan"):
        return None
    plan = (ctypes.c_int * 3)()
    if _build.library().k6_plan(lp, plan):
        fail(f"k6_plan refused Lp {lp}")
    tier, k, strips = plan
    if tier != myers.WARP:
        return {"tier": "thread"}
    per_block = 4 if strips == 1 else 1  # alignments a block (WARP_WPB)
    warps = 4 if strips == 1 else strips
    grid = -(-nb // per_block)
    out = {"tier": "warp", "words_per_lane": k, "strips": strips,
           "warps_per_block": warps, "grid": grid}
    match = [t for t in K6_BUILD if (t["k"], t["global"]) == (k, False)]
    if not match or "registers" not in match[0]:
        return out
    t = match[0]
    blocks = sm_blocks(t["registers"], t["smem"], warps)
    return dict(out, registers=t["registers"], smem=t["smem"],
                spill_stores=t.get("spill_stores"),
                blocks_per_sm=blocks, warps_per_sm=blocks * warps,
                sms_busy=min(grid, N_SMS),
                warps_per_sm_achieved=min(blocks, -(-grid // N_SMS)) * warps)


def k7_ptxas(text):
    """Registers, shared bytes and spills of each instantiation of K7's
    group kernel (k7_group_kernel<G, CPT, ATYPE, LUT, PINC>) from nvcc's
    ptxas report of banded_gotoh16.cu."""
    import re

    tiers, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            g = re.search(r"k7_group_kernelILi(\d+)ELi(\d+)ELi(\d)ELb([01])"
                          r"ELi(\d+)E", m.group(1))
            cur = None if not g else {
                "G": int(g[1]), "CPT": int(g[2]), "atype": int(g[3]),
                "byte_table": g[4] == "1", "pinned_cells": int(g[5])}
            if cur:
                tiers.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m[1]) if m else 0
    return tiers


def k7_occupancy(nb, lp, band_w, scheme):
    """The instantiation a K7 call of this shape takes, as the C entry
    k7_plan reports it (tier G x CPT over k7_live_range's live cells,
    the group's first band cell, the pinned cells a lane, the
    substitution form, the grid), its block (128 threads, 128 / G pairs
    of alignments), and from the ptxas registers and shared bytes of
    that SEMI_GLOBAL instantiation the blocks and warps an SM holds
    (sm_blocks) and those this call's grid keeps resident.  None for a
    package without the group kernel (the parent tree of a --turns run);
    no ptxas figures for a cached build."""
    import ctypes

    from nvbio_tpu_torch.ops import _build, banded_dp

    if not hasattr(banded_dp, "k7_live_range"):
        return None
    k_lo, n = banded_dp.k7_live_range(lp, band_w)
    plan = (ctypes.c_int * 6)()
    rc = _build.library().k7_plan(
        nb, lp, band_w, k_lo, scheme.match, scheme.mismatch_min,
        scheme.mismatch_max, scheme.n_penalty, plan)
    if rc:
        fail(f"k7_plan refused ({nb}, {lp}, band_w {band_w}): {rc}")
    g, cpt, k_start, pinc, lut, grid = plan
    out = {"G": g, "CPT": cpt, "live_cells": n, "k_lo": k_lo,
           "k_start": k_start, "pinned_cells": pinc, "byte_table": bool(lut),
           "grid": grid}
    match = [t for t in K7_BUILD if (t["G"], t["CPT"], t["atype"],
                                     t["pinned_cells"], t["byte_table"])
             == (g, cpt, 1, pinc, bool(lut))]
    if not match:
        return out
    t, warps = match[0], 128 // 32
    blocks = sm_blocks(t["registers"], t["smem"])
    resident = min(blocks, -(-grid // N_SMS))
    return dict(out, registers=t["registers"], smem=t["smem"],
                pairs_per_block=128 // g, blocks_per_sm=blocks,
                warps_per_sm=blocks * warps,
                warps_per_sm_achieved=resident * warps)


def group_ptxas(by_source):
    """Registers and spills of each instantiation of group_gotoh.cuh's
    kernel from nvcc's ptxas report, by source: K1's, K2's and K3's in
    banded_gotoh.cu, K4's (bands up to 128 cells) in long_gotoh.cu."""
    import re

    tiers = []
    for src, text in sorted(by_source.items()):
        cur = None
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                g = re.search(r"group_gotoh_kernelILi(\d+)ELi(\d+)ELi(\d)E"
                              r"Lb([01])ELb([01])ELb([01])E", m.group(1))
                cur = None if not g else {
                    "source": src, "G": int(g[1]), "CPT": int(g[2]),
                    "atype": int(g[3]), "packed": g[4] == "1",
                    "dirs": g[5] == "1", "byte_table": g[6] == "1"}
                if cur:
                    tiers.append(cur)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m and cur is not None:
                cur["registers"] = int(m[1])
                m = re.search(r"(\d+) bytes smem", ln)
                cur["smem"] = int(m[1]) if m else 0
    return tiers


def cuda_ms(torch, fn, reps, queued=True, warm=True):
    """Mean milliseconds per call, by CUDA events, after one warm-up
    (none with ``warm=False``).  A
    ~10 ms sleep kernel ahead of the start event lets the host queue the
    calls first, so a call shorter than its host-side launch cost is
    timed on the device, back to back.  With ``queued=False`` the calls
    start as the host issues them, so the time is the larger of the
    kernel's and the host's cost a call (the launch included)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def big_schemes():
    """A scheme for each alignment type with a score past a signed byte:
    the group kernel's compare-and-select substitution (no byte table)."""
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme

    return {AlignmentType.GLOBAL: GotohScheme(mismatch_min=150,
                                              mismatch_max=300),
            AlignmentType.SEMI_GLOBAL: GotohScheme(n_penalty=200),
            AlignmentType.LOCAL: GotohScheme(match=130)}


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
        # scores past a signed byte: the compare-and-select substitution
        big = dict(kw, scheme=big_schemes()[atype])
        errs["K1"] = max(errs["K1"], max_abs_err(
            torch, list(banded_dp.banded_score(
                pats, plens, texts, tlens, quals, **big).values()),
            list(banded_score_batch(pats, plens, texts, tlens, quals,
                                    **big).values())))
        errs["K3"] = max(errs["K3"], max_abs_err(
            torch, list(banded_dp.banded_score_packed(
                pats, plens, gwords, ws, tlens, quals, **big).values()),
            list(banded_dp.banded_score_packed_plain(
                pats, plens, gwords, ws, tlens, quals, **big).values())))
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
            f"the plain versions over {NB} windows ({n_ok} with a path); "
            "K1, K3 also with scores past a signed byte")
        if atype != AlignmentType.SEMI_GLOBAL:  # the mapper's type
            continue
        cells = band_cells(torch, plens, tlens, BAND_W)
        flag_bytes = NB * LP * (2 * BAND_W + 1)  # K2 writes every row
        io = (pats, quals, plens, tlens)
        for name, kern, plain, dirs, nbytes in (
                ("K1", k1, p1, False,
                 dp_bytes(*io, texts, out_bytes=12 * NB)),
                ("K3", k3, p3, False,
                 dp_bytes(*io, gwords, ws, out_bytes=12 * NB)),
                ("K2", k2, p2, True,
                 dp_bytes(*io, texts, out_bytes=12 * NB + flag_bytes))):
            ms, pms = cuda_ms(torch, kern, 10), cuda_ms(torch, plain, 2)
            bms, by, yard = gotoh_bound(cells, nbytes, dirs)
            out[name] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                         "bound_by": by, "yard_bound_ms": yard,
                         "cells": cells, "gcups": cells / ms / 1e6,
                         "plain_gcups": cells / pms / 1e6}
            log(f"[kernels] {name} SEMI_GLOBAL NB={NB} Lp={LP} "
                f"band_w={BAND_W}: kernel {ms:.4f} ms ({cells / ms / 1e6:.1f}"
                f" GCUPS), plain {pms:.3f} ms; bound {bms:.4f} ms ({by}), "
                f"share {bms / ms:.3f} (yardstick {yard / ms:.3f})")
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
        cells = band_cells(torch, plens, tlens, LONG_W)
        cells_d = band_cells(torch, plens[:nd], tlens[:nd], LONG_W)
        ms, pms = cuda_ms(torch, k4, 10), cuda_ms(torch, p4, 2)
        dms, dpms = cuda_ms(torch, k4d, 10), cuda_ms(torch, p4d, 2)
        bms, by, yard = gotoh_bound(
            cells, dp_bytes(*args, out_bytes=12 * LONG_NB))
        dbms, dby, dyard = gotoh_bound(cells_d, dp_bytes(
            *dargs, out_bytes=12 * nd + nd * LONG_LP * (2 * LONG_W + 1)),
            dirs=True)
        out = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
               "yard_bound_ms": yard, "dirs_bound_ms": dbms,
               "dirs_bound_by": dby, "dirs_yard_bound_ms": dyard,
               "gcups": cells / ms / 1e6,
               "plain_gcups": cells / pms / 1e6, "dirs_ms": dms,
               "dirs_plain_ms": dpms, "dirs_gcups": cells_d / dms / 1e6,
               "dirs_plain_gcups": cells_d / dpms / 1e6}
        log(f"[k4] SEMI_GLOBAL score-only NB={LONG_NB}: kernel {ms:.4f} ms "
            f"({out['gcups']:.1f} GCUPS), plain {pms:.1f} ms, bound "
            f"{bms:.4f} ms ({by}), share {bms / ms:.3f} (yardstick "
            f"{yard / ms:.3f}); with flags NB={nd}: kernel {dms:.4f} ms "
            f"({out['dirs_gcups']:.1f} GCUPS), plain {dpms:.1f} ms, bound "
            f"{dbms:.4f} ms ({dby}), share {dbms / dms:.3f} (yardstick "
            f"{dyard / dms:.3f})")
    out["max_abs_err"] = worst
    return out


def rescue_wide_inputs(np, nb, lp, band_w, genome, rng, mate=100):
    """The PE --local rescue's window-wide call: ``mate``-bp mates (10
    shorter on a few lanes, zero-length lanes too) bucketed to lp rows,
    planted with 2 % substitutions (N among them) at an insert-like offset
    anywhere the band reaches in their lp + 2 * band_w windows, every
    eighth a random read (no place); windows clamped at the genome's end
    on a few lanes (the rescue's tlen spread: Lt, less at the end)."""
    n = len(genome)
    lt = lp + 2 * band_w
    ws = rng.integers(0, n - lt, nb)
    ws[:4] = [n - 1, n - 150, n - lt // 2, n - lt + 40]
    gpad = np.concatenate([genome, np.full(lt + 16, 7, np.int8)])
    texts = gpad[ws[:, None] + np.arange(lt)]
    plens = np.full(nb, mate, np.int32)
    plens[::16] = rng.integers(mate - 10, mate + 1, len(plens[::16]))
    plens[4:6] = 0
    off = rng.integers(0, 2 * band_w + 1, nb)
    pats = gpad[np.minimum((ws + off)[:, None] + np.arange(lp),
                           len(gpad) - 1)]
    pats[::8] = rng.integers(0, 4, (len(pats[::8]), lp))
    pats = np.where(pats == 7, rng.integers(0, 4, pats.shape), pats)
    mut = rng.random(pats.shape) < 0.02
    pats[mut] = rng.integers(0, 5, int(mut.sum()))
    pats = np.where(np.arange(lp)[None, :] < plens[:, None], pats, 7)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    tlens = np.clip(n - ws, 0, lt).astype(np.int32)
    return (pats.astype(np.int8), plens, texts.astype(np.int8), tlens,
            quals)


def sweep_occupancy(nb, lp, band_w, atype):
    """The tier wide_plan gives a score-only K4 call of this shape and,
    on the sweep, its rows a lane, warps (alignments) a block, the
    registers of its instantiation for ``atype`` over symbol windows with
    the byte table (phase 2), the warps an SM it keeps resident (C entry
    k4_sweep_warps_per_sm) and those this call's grid fills; None for a
    package without the plan (the parent of a --turns run)."""
    from nvbio_tpu_torch.ops import _build, long_dp

    if not hasattr(long_dp, "wide_plan"):
        return None
    tier, rpl, warps = long_dp.wide_plan(lp, band_w)
    out = {"tier": ["group", "sweep", "block"][tier]}
    if tier != long_dp.SWEEP:
        return out
    per_sm = _build.library().k4_sweep_warps_per_sm(lp, band_w, atype.value)
    grid = -(-nb // warps)
    match = [t for t in K4_SWEEP_BUILD if (t["rpl"], t["atype"], t["packed"],
                                           t["byte_table"])
             == (rpl, atype.value, False, True)]
    return dict(out, rows_per_lane=rpl, warps_per_block=warps, grid=grid,
                registers=match[0].get("registers") if match else None,
                warps_per_sm=per_sm,
                warps_per_sm_achieved=min(per_sm,
                                          -(-grid // N_SMS) * warps))


def phase_k4_wide(torch, np):
    """K4's score tier past 128 cells at the PE --local rescue's call
    (K4W_*, rescue_wide_inputs): LOCAL (row K4_wide) and SEMI_GLOBAL (row
    K4_wide_semi) on 100 bp mates, LOCAL on 150 bp mates (row
    K4_wide_150, Lp K4W_LP150), against the plain version bit for bit,
    each call asserted to take wide_plan's tier (the sweep) as the kernel
    library reports it; CUDA-event times queued and as issued, bound,
    block shape and warps an SM."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.ops import banded_dp, long_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 21)
    genome = rng.integers(0, 4, 4_000_000).astype(np.int8)
    inputs = {}
    keys = ("score", "p_end", "t_end")
    out = {}
    for name, atype, scheme, lp, mate in (
            ("K4_wide", AlignmentType.LOCAL, GotohScheme(match=2), K4W_LP,
             100),
            ("K4_wide_semi", AlignmentType.SEMI_GLOBAL, GotohScheme(),
             K4W_LP, 100),
            ("K4_wide_150", AlignmentType.LOCAL, GotohScheme(match=2),
             K4W_LP150, 150)):
        if lp not in inputs:
            inputs[lp] = tuple(torch.from_numpy(a).to(dev)
                               for a in rescue_wide_inputs(
                                   np, K4W_NB, lp, K4W_W, genome, rng,
                                   mate))
        args = inputs[lp]
        plens, tlens = args[1], args[3]
        plan = (long_dp.wide_plan(lp, K4W_W)
                if hasattr(long_dp, "wide_plan") else None)
        cells = band_cells(torch, plens, tlens, K4W_W)
        kw = dict(scheme=scheme, atype=atype, band_w=K4W_W)

        def kern():
            return banded_dp.banded_score(*args, **kw)

        def plain():
            return banded_score_batch(*args, **kw)

        banded_dp.reset_launch_counts()
        got = kern()
        torch.cuda.synchronize()
        sweeps = getattr(long_dp.launch, "sweep_launches", None)
        if long_dp.launch.launches != 1 or (
                plan and sweeps != int(plan[0] == long_dp.SWEEP)):
            fail(f"{name}: K4 launches {long_dp.launch.launches}, on the "
                 f"sweep {sweeps}, plan {plan}")
        want = plain()
        err = max_abs_err(torch, [got[k] for k in keys],
                          [want[k] for k in keys])
        n_ok = int((want["score"] > (0 if atype == AlignmentType.LOCAL
                                     else -(1 << 29))).sum())
        if err or n_ok < K4W_NB // 2:
            fail(f"{name}: max_abs_err {err}, {n_ok} of {K4W_NB} lanes "
                 "placed")
        ms = cuda_ms(torch, kern, 20)
        launch_ms = cuda_ms(torch, kern, 20, queued=False)
        pms = cuda_ms(torch, plain, 1)
        bms, by, yard = gotoh_bound(cells, dp_bytes(*args,
                                                    out_bytes=12 * K4W_NB))
        occ = sweep_occupancy(K4W_NB, lp, K4W_W, atype)
        out[name] = {"shape": [K4W_NB, lp, args[2].shape[1]],
                     "band_w": K4W_W, "atype": atype.name, "mate": mate,
                     "ms": ms, "launch_ms": launch_ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "yard_bound_ms": yard,
                     "cells": cells, "gcups": cells / ms / 1e6,
                     "placed": n_ok, "max_abs_err": err, "occupancy": occ}
        log(f"[k4_wide] {name}: {atype.name} {K4W_NB} x {lp} (Lt "
            f"{args[2].shape[1]}, {mate} bp mates), band_w {K4W_W}, {n_ok} "
            f"lanes placed: bit-identical to the plain version; {ms:.4f} ms"
            f" queued, {launch_ms:.4f} ms as issued "
            f"({cells / ms / 1e6:.1f} GCUPS), bound {bms:.4f} ms ({by}), "
            f"share {bms / ms:.3f}, plain {pms:.2f} ms; {occ}")
    return out


def rescue_shape():
    """(NB, Lp, Lt, band_w) of the paired-end rescue's K4 call on a full
    4096-pair batch of 100 bp mates (bucketed to 128 rows): paired.
    pe_map_batch compacts the rescue to capR = 1024 lanes, and
    _chunked_window_score runs them over C chunks of CW columns in one
    banded_score call.  phase_pe reads the real call's shape and checks
    it against this."""
    from nvbio_tpu_torch.models.paired import _chunk_plan
    from nvbio_tpu_torch.models.params import MapperParams

    p = MapperParams()
    lp = 128
    w_c, cw, origins = _chunk_plan(lp, lp + 2 * (p.maxins + 2 * p.band_w), p)
    return 1024 * len(origins), lp, cw, w_c


def group_tier(band_w, dirs):
    """(G lanes, CPT cells a lane) of group_gotoh.cuh's with_tier for a
    band of 2 * band_w + 1 cells, None past its 128."""
    band = 2 * band_w + 1
    if band > 128:
        return None
    if band <= 16:
        return 4, 4
    if dirs:
        return (8 if band <= 32 else 16 if band <= 64 else 32), 4
    return (4 if band <= 32 else 8 if band <= 64 else 16), 8


def sm_blocks(registers, smem, warps=4):
    """128-thread blocks an SM holds by sm_90's occupancy rules (64 warps,
    32 blocks, 64 K registers allocated 256 a warp, 228 KiB of shared
    memory with 1 KiB reserved a block)."""
    by_regs = 65536 // (warps * -(-registers * 32 // 256) * 256)
    return min(32, 64 // warps, by_regs, 233_472 // (smem + 1024))


def occupancy(kernel, band_w, nb, dirs):
    """The block shape of the group kernel a K1-K4 call of this band
    launches over ``nb`` alignments (count those with a pattern: a warp
    of zero-length lanes runs no row) (group_tier; 128 threads, 128 / G
    alignments a block), the blocks an SM holds (sm_blocks) from the
    ptxas registers and shared bytes of its SEMI_GLOBAL instantiation,
    and the warps an SM this call's grid keeps resident.  None without a
    ptxas report of the group kernel (a cached build, the parent tree of
    a --turns run)."""
    tier = group_tier(band_w, dirs)
    src = "long_gotoh.cu" if kernel == "K4" else "banded_gotoh.cu"
    match = [t for t in GROUP_TIERS or () if tier and t["source"] == src
             and (t["G"], t["CPT"]) == tier and t["atype"] == 1
             and t["packed"] == (kernel == "K3") and t["dirs"] == dirs
             and t["byte_table"]]
    if not match:
        return None
    t, warps = match[0], 128 // 32
    blocks = sm_blocks(t["registers"], t["smem"])
    per_block = 128 // tier[0]
    grid = -(-nb // per_block)
    resident = min(blocks, -(-grid // N_SMS))
    return {"G": tier[0], "CPT": tier[1], "alignments_per_block": per_block,
            "registers": t["registers"], "smem": t["smem"],
            "blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "grid": grid, "warps_per_sm_achieved": resident * warps}


def phase_path_shapes(torch, np):
    """K2, K3 and K4 at the shapes their paths give them, all three types
    against the plain versions (K3 also with scores past a signed byte),
    SEMI_GLOBAL timed by CUDA events with its bound, queued and as the
    host issues the calls (launch_ms): K2 over the 4096 winners of a
    short-read batch (128 rows, band_w 15), K3 over a batch's extension
    slots (K3_PATH_NB lanes, the first K3_PATH_LIVE with a pattern) and
    K4 at the paired-end rescue's chunked call."""
    from nvbio_tpu_torch.alignment.batched import (banded_directions_batch,
                                                   banded_score_batch)
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.ops import banded_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 10)
    genome = rng.integers(0, 4, 8_000_000).astype(np.int8)
    rnb, rlp, rlt, rw = rescue_shape()
    gwords = banded_dp.pack_genome_words(genome, device=dev)
    rows = [("K2_path", "K2", True, dp_inputs(np, K2_PATH_NB, LP, BAND_W,
                                               genome, rng), BAND_W, 10)]
    res_in = list(long_inputs(np, rnb, rlp, rw, genome, rng))
    res_in[2] = np.ascontiguousarray(res_in[2][:, :rlt])
    res_in[3] = np.minimum(res_in[3], rlt)
    res_in[6] = np.minimum(res_in[6], rlt)
    k3_in = dp_inputs(np, K3_PATH_NB, LP, BAND_W, genome, rng)
    k3_in[1][K3_PATH_LIVE:] = 0  # the pad lanes past the kept candidates
    rows.append(("K3_path", "K3", False, k3_in, BAND_W, 10))
    rows.append(("K4_rescue", "K4", False, tuple(res_in), rw, 10))
    keys = ("score", "p_end", "t_end")
    out = {}
    for name, kernel, dirs, arrays, w, reps in rows:
        pats, plens, texts, win_tlens, quals, ws, global_tlens = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays)
        nb, lp = pats.shape
        live = int((plens > 0).sum())
        worst = 0
        schemes = [(atype, GotohScheme(
            match=2 if atype == AlignmentType.LOCAL else 0), True)
            for atype in AlignmentType]
        if kernel == "K3":  # the compare-and-select substitution too
            schemes += [(a, sc, False) for a, sc in big_schemes().items()]
        for atype, scheme, timed in schemes:
            tlens = (global_tlens if atype == AlignmentType.GLOBAL
                     else win_tlens)
            kw = dict(scheme=scheme, atype=atype, band_w=w)
            args = (pats, plens, texts, tlens, quals)
            if kernel == "K3":
                pargs = (pats, plens, gwords, ws, tlens, quals)

                def kern():
                    return banded_dp.banded_score_packed(*pargs, **kw)

                def plain():
                    return banded_dp.banded_score_packed_plain(*pargs, **kw)
            elif dirs:
                def kern():
                    return banded_dp.banded_directions(*args, **kw)

                def plain():
                    return banded_directions_batch(*args, **kw)
            else:
                def kern():
                    return banded_dp.banded_score(*args, **kw)

                def plain():
                    return banded_score_batch(*args, **kw)
            banded_dp.reset_launch_counts()
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if banded_dp.KERNELS[kernel].launches != 1:
                fail(f"{name} ({nb} x {lp}, band_w {w}) did not launch "
                     f"{kernel}: "
                     f"{ {k: f.launches for k, f in banded_dp.KERNELS.items()} }")
            if dirs:
                (r, d), (wr, wd) = got, want
                err = max(max_abs_err(torch, [r[k] for k in keys] + [d],
                                      [wr[k] for k in keys] + [wd]),
                          max_abs_err(torch, walk_outputs(torch, r, d, w),
                                      walk_outputs(torch, wr, wd, w)))
                want = wr
            else:
                err = max_abs_err(torch, [got[k] for k in keys],
                                  [want[k] for k in keys])
            n_ok = int((want["score"] > -(1 << 29)).sum())
            if err or n_ok < live // 3:
                fail(f"{name} {atype.name}: max_abs_err {err}, {n_ok} of "
                     f"{live} lanes with a path")
            worst = max(worst, err)
            if atype != AlignmentType.SEMI_GLOBAL or not timed:
                continue
            cells = band_cells(torch, plens, tlens, w)
            ms, pms = cuda_ms(torch, kern, reps), cuda_ms(torch, plain, 1)
            launch_ms = cuda_ms(torch, kern, reps, queued=False)
            flag_bytes = nb * lp * (2 * w + 1) if dirs else 0
            bms, by, yard = gotoh_bound(
                cells, dp_bytes(*(pargs if kernel == "K3" else args),
                                out_bytes=12 * nb + flag_bytes), dirs)
            occ = occupancy(kernel, w, live, dirs)
            out[name] = {"kernel": kernel, "shape": [nb, lp, texts.shape[1]],
                         "live": live, "band_w": w, "dirs": dirs, "ms": ms,
                         "launch_ms": launch_ms, "plain_ms": pms,
                         "bound_ms": bms, "bound_by": by,
                         "yard_bound_ms": yard, "cells": cells,
                         "gcups": cells / ms / 1e6, "occupancy": occ}
        out[name]["max_abs_err"] = worst
        o = out[name]
        log(f"[path] {name}: {kernel}{' with flags' if dirs else ''} "
            f"{nb} x {lp} (Lt {texts.shape[1]}, {live} lanes with a pattern)"
            f", band_w {w}: all three types bit-identical to the plain "
            f"version{' (walks too)' if dirs else ''}"
            f"{', both substitution forms' if kernel == 'K3' else ''};"
            f" SEMI_GLOBAL {o['ms']:.4f} ms queued, {o['launch_ms']:.4f} ms as"
            f" issued ({o['gcups']:.1f} GCUPS), bound {o['bound_ms']:.4f} ms "
            f"({o['bound_by']}), share {o['bound_ms'] / o['ms']:.3f} "
            f"(yardstick {o['yard_bound_ms'] / o['ms']:.3f}), plain "
            f"{o['plain_ms']:.2f} ms; block shape {o['occupancy']}")
        del pats, texts, quals
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
                      "K5_dirs": 0, "K5_matrix": 0, "K6": 0, "K7": 0}:
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
    """K1 at bench.py's problem shape (all rows full length, band_w 15),
    and on an eighth of its lanes at band_w 31, the widest band K1 keeps
    (63 cells; wider goes to K4)."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.ops import banded_dp

    dev = torch.device(DEV)
    out = {}
    for name, nb, w in (("K1_bench", BENCH_NB, BAND_W),
                        ("K1_w31", BENCH_NB // 8, 31)):
        rng = np.random.default_rng(0)
        lt = BENCH_LP + 2 * w
        pats = torch.from_numpy(rng.integers(0, 4, (nb, BENCH_LP),
                                             dtype=np.int8)).to(dev)
        texts = torch.from_numpy(rng.integers(0, 4, (nb, lt),
                                              dtype=np.int8)).to(dev)
        texts[:, w:w + BENCH_LP] = pats
        for _ in range(3):  # sprinkle mutations, as bench.py does
            ii = torch.from_numpy(rng.integers(0, lt, nb)).to(dev)
            texts[torch.arange(nb, device=dev), ii] = torch.from_numpy(
                rng.integers(0, 4, nb, dtype=np.int8)).to(dev)
        plens = torch.full((nb,), BENCH_LP, dtype=torch.int32, device=dev)
        tlens = torch.full((nb,), lt, dtype=torch.int32, device=dev)
        quals = torch.from_numpy(rng.integers(20, 41, (nb, BENCH_LP),
                                              dtype=np.uint8)).to(dev)
        kw = dict(scheme=GotohScheme(), atype=AlignmentType.SEMI_GLOBAL,
                  band_w=w)
        args = (pats, plens, texts, tlens, quals)
        got = banded_dp.banded_score(*args, **kw)
        want = banded_score_batch(*args, **kw)
        err = max_abs_err(torch, list(got.values()), list(want.values()))
        if err:
            fail(f"K1 differs from its plain version at {name}: {err}")
        cells = band_cells(torch, plens, tlens, w)
        ms = cuda_ms(torch, lambda: banded_dp.banded_score(*args, **kw), 5)
        pms = cuda_ms(torch, lambda: banded_score_batch(*args, **kw), 1)
        bms, by, yard = gotoh_bound(cells, dp_bytes(*args, out_bytes=12 * nb))
        log(f"[bench] {name}: K1 {nb} x {BENCH_LP} bp x band {2 * w + 1}: "
            f"{ms:.3f} ms = {cells / ms / 1e6:.1f} GCUPS (plain version "
            f"{pms:.1f} ms = {cells / pms / 1e6:.2f} GCUPS), bit-identical; "
            f"bound {bms:.3f} ms ({by}), share {bms / ms:.3f} (yardstick "
            f"{yard / ms:.3f})")
        out[name] = {"ms": ms, "gcups": cells / ms / 1e6, "plain_ms": pms,
                     "plain_gcups": cells / pms / 1e6, "bound_ms": bms,
                     "bound_by": by, "yard_bound_ms": yard, "band_w": w,
                     "nb": nb, "max_abs_err": err}
        del pats, texts, quals
    return out


def phase_k7(torch, np, only=None):
    """The int16 opt-in: banded_score(compute_dtype="int16") at
    K7_SHAPES (the row, mid and wide shapes and Lp 128 at band_w 7 and
    31), all three types, with the counts reset just before: only K7
    launched, each call against K7's plain version; each shape timed in
    SEMI_GLOBAL against the int32 call's kernel (K1, or K4 past 64 cells)
    in turns, with its tier and the warps an SM it keeps resident.
    ``only``: the timed_rows names whose shapes to time (all by
    default)."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch16
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme
    from nvbio_tpu_torch.ops import banded_dp

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 9)
    genome = rng.integers(0, 4, 4_000_000).astype(np.int8)
    shapes = {name: sh for name, sh in K7_SHAPES.items()
              if only is None or K7_ROWS[name] in only}
    inputs = {name: [torch.from_numpy(a).to(dev) for a in dp_inputs(
        np, nb, lp, w, genome, rng)] for name, (nb, lp, w) in shapes.items()}

    def call_args(name, atype):
        pats, plens, texts, win_tlens, quals, _, global_tlens = inputs[name]
        tlens = global_tlens if atype == AlignmentType.GLOBAL else win_tlens
        kw = dict(scheme=GotohScheme(match=2 if atype == AlignmentType.LOCAL
                                     else 0), atype=atype,
                  band_w=shapes[name][2])
        return (pats, plens, texts, tlens, quals), kw

    # the path's run: every int16 call of the phase, counts reset before
    banded_dp.reset_launch_counts()
    got = {}
    for name, (nb, lp, w) in shapes.items():
        for atype in AlignmentType:
            args, kw = call_args(name, atype)
            if banded_dp.route(lp, w, False, compute_dtype="int16",
                               scheme=kw["scheme"]) != "K7":
                fail(f"K7 phase: {name} shape ({lp}, band_w {w}) is outside"
                     " the int16 guard")
            got[name, atype] = banded_dp.banded_score(
                *args, compute_dtype="int16", **kw)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    if launches["K7"] != len(got) or sum(launches.values()) != len(got):
        fail(f"the int16 opt-in calls did not all launch K7: {launches}")
    keys = ("score", "p_end", "t_end")
    worst, out = 0, {"launches": launches["K7"]}
    for (name, atype), r in got.items():
        args, kw = call_args(name, atype)
        w = banded_score_batch16(*args, **kw)
        err = max_abs_err(torch, [r[k] for k in keys], [w[k] for k in keys])
        n_ok = int((w["score"] > -(1 << 29)).sum())
        if err:
            fail(f"K7 differs from its plain version ({name}, {atype.name}):"
                 f" max_abs_err {err}")
        if n_ok < args[0].shape[0] // 3:
            fail(f"K7 {name} {atype.name}: only {n_ok} lanes have a path")
        worst = max(worst, err)
        log(f"[k7] {name} {tuple(args[0].shape)} band_w {kw['band_w']} "
            f"{atype.name}: bit-identical to the plain version ({n_ok} lanes"
            " with a path)")
    for name, (nb, lp, w) in shapes.items():
        args, kw = call_args(name, AlignmentType.SEMI_GLOBAL)
        cells = band_cells(torch, args[1], args[3], w)

        def k7():
            return banded_dp.banded_score(*args, compute_dtype="int16", **kw)

        def k32():
            return banded_dp.banded_score(*args, **kw)

        def p7():
            return banded_score_batch16(*args, **kw)

        # K7 and the int32 call's kernel (K1; K4 past 64 cells) in turns
        k32_name = banded_dp.route(lp, w, False)
        t7a, t1a = cuda_ms(torch, k7, 10), cuda_ms(torch, k32, 10)
        t1b, t7b = cuda_ms(torch, k32, 10), cuda_ms(torch, k7, 10)
        ms, k32_ms = (t7a + t7b) / 2, (t1a + t1b) / 2
        pms = cuda_ms(torch, p7, 2)
        bms, by, yard = gotoh_bound(
            cells, dp_bytes(*args, out_bytes=12 * nb), per_lane=2)
        occ = k7_occupancy(nb, lp, w, kw["scheme"])
        out[name] = {"ms": ms, "ms_turns": [t7a, t7b],
                     "int32_kernel": k32_name, "int32_ms": k32_ms,
                     "int32_ms_turns": [t1a, t1b], "plain_ms": pms,
                     "bound_ms": bms, "bound_by": by, "yard_bound_ms": yard,
                     "cells": cells, "gcups": cells / ms / 1e6,
                     "int32_gcups": cells / k32_ms / 1e6, "occupancy": occ}
        tier = (f"; tier {occ['G']} x {occ['CPT']} over {occ['live_cells']} "
                f"live cells from k {occ['k_lo']}"
                + (f", {occ['registers']} registers, "
                   f"{occ['warps_per_sm_achieved']} warps an SM"
                   if "registers" in occ else "") if occ else "")
        log(f"[k7] SEMI_GLOBAL {name} NB={nb} Lp={lp} band_w={w}: K7 "
            f"{t7a:.4f} / {t7b:.4f} ms ({cells / ms / 1e6:.1f} GCUPS), "
            f"{k32_name} {t1a:.4f} / {t1b:.4f} ms ("
            f"{cells / k32_ms / 1e6:.1f} GCUPS), plain {pms:.1f} ms; bound "
            f"{bms:.4f} ms ({by}), share {bms / ms:.3f} (yardstick "
            f"{yard / ms:.3f}){tier}")
    first = out[next(iter(shapes))]
    return dict(out, ms=first["ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                max_abs_err=worst)


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
    plens[2], tlens[2] = max(lp - 333, 1), max(lt - 777, 1)
    tlens[3] = max(lp - band_w - 500, 0)
    quals = rng.integers(0, 42, (nb, lp)).astype(np.uint8)
    return pats, plens, texts, tlens, quals


def band_cells(torch, plens, tlens, band_w):
    """In-band cells a banded Gotoh call needs, summed over its lanes:
    rows 1..plen, and in row r the columns r - band_w .. r + band_w that
    lie in 0..tlen (the valid cells of the plain versions' row loop).
    The count for every score bound and GCUPS figure of K1-K5 and K7."""
    p = plens.to(torch.int64)
    t = tlens.to(torch.int64)
    cells = torch.zeros((), dtype=torch.int64, device=p.device)
    for r in range(1, int(p.max()) + 1 if p.numel() else 1):
        n = (t.clamp(max=r + band_w) - max(r - band_w, 0) + 1).clamp(min=0)
        cells += torch.where(p >= r, n, 0).sum()
    return int(cells)


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

        sweep0 = getattr(wavefront_dp.wavefront_score, "sweep_launches",
                         None)
        r, w = k5(), p5()
        torch.cuda.synchronize()
        err = max_abs_err(torch, [r[k] for k in keys], [w[k] for k in keys])
        n_ok = int((w["score"] > -(1 << 29)).sum())
        if err:
            fail(f"K5 differs from its plain version ({atype.name}): "
                 f"max_abs_err {err}")
        if sweep0 is not None and (
                wavefront_dp.wavefront_score.sweep_launches != sweep0 + 1):
            fail(f"K5 {atype.name} at Lp {WIDE_LP}, band_w {WIDE_W} did "
                 "not take the banded column-sweep tier")
        if sweep0 is not None:
            # the diagonal score kernel, which the tier's gate leaves
            # patterns past BAND_MAX_LP, on the same inputs (its C entry,
            # uncounted)
            err = max(err, k5_diagonal_err(torch, wavefront_dp, args, kw, w))
        if n_ok < WIDE_NB // 2:
            fail(f"K5 {atype.name}: only {n_ok} of {WIDE_NB} lanes have a "
                 "path, too few for the comparison to mean much")
        worst = max(worst, err)
        which = ("" if sweep0 is None else
                 ", the banded tier and the diagonal kernel")
        log(f"[k5] {atype.name}: score-only over {WIDE_NB} lanes ({n_ok} "
            f"with a path) bit-identical to the plain version (Lp "
            f"{WIDE_LP}, Lt {WIDE_LP + 2 * WIDE_W}, band_w {WIDE_W}{which})")
        if atype != AlignmentType.SEMI_GLOBAL:  # sw_benchmark's type
            continue
        cells = band_cells(torch, plens, tlens, WIDE_W)
        ms, pms = cuda_ms(torch, k5, 5), cuda_ms(torch, p5, 1)
        bms, by, yard = gotoh_bound(cells,
                                    dp_bytes(*args, out_bytes=12 * WIDE_NB))
        row_cells = WIDE_NB * WIDE_LP * (2 * WIDE_W + 1)
        out["K5"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by, "yard_bound_ms": yard, "cells": cells,
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

        fn = wavefront_dp.wavefront_dirs
        sweep0 = getattr(fn, "sweep_launches", None)
        launches0 = fn.launches
        (rd, dd), (wd, ed) = k5d(), p5d()
        torch.cuda.synchronize()
        if sweep0 is not None and (fn.sweep_launches - sweep0
                                   != fn.launches - launches0 or
                                   fn.launches != launches0 + 1):
            fail("K5 with flags did not take the flag tier: "
                 f"{fn.launches - launches0} launches, "
                 f"{fn.sweep_launches - sweep0} on the tier")
        err = max(max_abs_err(torch, [rd[k] for k in keys] + [dd],
                              [wd[k] for k in keys] + [ed]),
                  max_abs_err(torch, [rd[k] for k in keys],
                              [r[k][:nd] for k in keys]))
        # (the walks of a --turns parent without the sweep layout take no
        # widths)
        wkw = ({"lp": WIDE_LP, "lt": texts.shape[1]} if "lp" in
               inspect.signature(walk_wavefront_dirs_device).parameters
               else {})
        walk = walk_wavefront_dirs_device(dd, rd["p_end"], rd["t_end"],
                                          band_w=WIDE_W, **wkw)
        walk_p = walk_wavefront_dirs_device(ed, wd["p_end"], wd["t_end"],
                                            band_w=WIDE_W, **wkw)
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
        cells_d = band_cells(torch, plens[:nd], tlens[:nd], WIDE_W)
        row_cells_d = nd * WIDE_LP * (2 * WIDE_W + 1)
        dms, dpms = cuda_ms(torch, k5d, 3), cuda_ms(torch, p5d, 1)
        dbms, dby, dyard = gotoh_bound(
            cells_d, dp_bytes(*dargs, out_bytes=12 * nd + cells_d // 2),
            dirs=True)
        out["K5_dirs"] = {"ms": dms, "plain_ms": dpms, "bound_ms": dbms,
                          "bound_by": dby, "yard_bound_ms": dyard,
                          "cells": cells_d,
                          "flag_bytes": dd.numel() * dd.element_size(),
                          "gcups": cells_d / dms / 1e6,
                          "plain_gcups": cells_d / dpms / 1e6,
                          "tool_gcups": row_cells_d / dms / 1e6,
                          "occupancy": k5_dirs_occupancy(torch, wavefront_dp,
                                                         nd, WIDE_LP)}
        log(f"[k5] with flags NB={nd}: every flag byte "
            f"({dd.numel() * dd.element_size()}) and "
            f"the device walk equal the plain version's, device walk = "
            f"host walk; kernel {dms:.3f} ms ({cells_d / dms / 1e6:.1f} "
            f"GCUPS over the {cells_d} cells needed, "
            f"{row_cells_d / dms / 1e6:.1f} as sw_benchmark counts), plain "
            f"{dpms:.1f} ms; bound {dbms:.3f} ms ({dby}); grid "
            f"{out['K5_dirs']['occupancy']}")
        del dd, ed, rd, wd
    out["K5"]["max_abs_err"] = out["K5_dirs"]["max_abs_err"] = worst
    if hasattr(wavefront_dp, "band_tier"):
        out["K5"]["threshold"] = k5_threshold(torch, np, wavefront_dp, rng)
    return out


def k5_dirs_occupancy(torch, wavefront_dp, nb, lp):
    """The flag tier's grid for ``nb`` alignments of width ``lp`` (blocks
    a cluster, warps a block: one block an SM) and the warps an SM its
    SEMI_GLOBAL kernel keeps resident; None for a package without the
    tier (the parent of a --turns run)."""
    if not hasattr(wavefront_dp, "dirs_plan"):
        return None
    cluster, warps = wavefront_dp.dirs_plan(nb, lp, torch.device(DEV))
    lib = wavefront_dp._build.library()
    return {"cluster": cluster, "warps_per_block": warps,
            "blocks": nb * cluster,
            "warps_per_sm": lib.k5_band_dirs_warps_per_sm(1, nb, lp),
            "warps_per_sm_achieved": warps}


def k5_diagonal_err(torch, wavefront_dp, args, kw, want):
    """max_abs_err of K5's diagonal score kernel (C entry
    k5_wavefront_score, launched without the wrapper, so no count moves)
    against the plain version's ``want`` on the same inputs; fails on a
    difference or a moved count."""
    keys = ("score", "p_end", "t_end")
    fn = wavefront_dp.wavefront_score
    before = (fn.launches, fn.sweep_launches)
    got = wavefront_dp._launch_k5(*args, kw["scheme"], kw["atype"],
                                  kw["band_w"], "k5_wavefront_score")
    torch.cuda.synchronize()
    err = max_abs_err(torch, [got[k] for k in keys], [want[k] for k in keys])
    if err or (fn.launches, fn.sweep_launches) != before:
        fail(f"K5's diagonal score kernel ({kw['atype'].name}, band_w "
             f"{kw['band_w']}) against its plain version: max_abs_err "
             f"{err}, counts {before} -> {(fn.launches, fn.sweep_launches)}")
    return err


#: k5_threshold's shapes: (NB, Lp, band_w of wide_inputs, band_w of the
#: call): sw_benchmark's 128 x 4 000 at bands below its 2 000, another
#: Lp, and many short alignments, the last at full_score_batch's band
#: (max(Lp, Lt))
K5_THRESHOLD_SHAPES = (
    *((128, 4000, w, w) for w in (16, 64, 128, 256, 512)),
    *((128, 1000, w, w) for w in (16, 64, 256)),
    (4096, 150, 16, 16), (4096, 150, 64, 64), (4096, 150, 150, 450))


def k5_threshold(torch, np, wavefront_dp, rng):
    """Both K5 score kernels, the banded column sweep (C entry
    k5_band_score) and the diagonal kernel (k5_wavefront_score), launched
    without the wrapper on SEMI_GLOBAL wide_inputs batches at
    K5_THRESHOLD_SHAPES: each equal to the plain version
    (banded_score_batch(twin=True)) bit for bit, CUDA-event ms of each,
    and which one the wrapper's gate (band_tier) picks."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme

    keys = ("score", "p_end", "t_end")
    res = {}
    for nb, lp, w_in, band_w in K5_THRESHOLD_SHAPES:
        args = [torch.from_numpy(a).to(DEV)
                for a in wide_inputs(np, nb, lp, w_in, rng)]
        scheme, atype = GotohScheme(), AlignmentType.SEMI_GLOBAL
        want = banded_score_batch(*args, scheme=scheme, atype=atype,
                                  band_w=band_w, twin=True)
        ms = {}
        for name, entry in (("band", "k5_band_score"),
                            ("diagonal", "k5_wavefront_score")):
            def k5():
                return wavefront_dp._launch_k5(*args, scheme, atype, band_w,
                                               entry)

            got = k5()
            torch.cuda.synchronize()
            err = max_abs_err(torch, [got[k] for k in keys],
                              [want[k] for k in keys])
            if err:
                fail(f"K5's {name} score kernel at {nb} x {lp}, band_w "
                     f"{band_w} differs from its plain version: "
                     f"max_abs_err {err}")
            ms[name] = cuda_ms(torch, k5, 5)
        gate = "band" if wavefront_dp.band_tier(lp) else "diagonal"
        res[f"{nb}x{lp}/{band_w}"] = dict(ms, gate=gate)
        log(f"[k5] threshold, {nb} x {lp} at band_w {band_w}: banded tier "
            f"{ms['band']:.4f} ms, diagonal kernel {ms['diagonal']:.4f} ms, "
            f"both equal to the plain version; the gate takes the {gate} "
            "kernel")
    return res


def myers_inputs(np, rng, nb, lp, lt):
    """Patterns planted mid-text with 3 % substitutions (N included),
    ragged and zero lengths; past MYERS_HOLD_LP the held lanes' plens lie
    on word, lane and strip edges (1, 33, 65, 1 025, 2 049 and 4 097
    symbols; the full and a ragged length) and lanes 0 and 3 carry a
    poly-A run from symbol 700 to 3 000 that the text never matches, so
    the add's all-ones propagate crosses lanes and strips."""
    pats = rng.integers(0, 4, (nb, lp)).astype(np.int8)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int8)
    off = (lt - lp) // 2
    texts[:, off:off + lp] = pats
    mut = rng.random(texts.shape) < 0.03
    texts[mut] = rng.integers(0, 5, int(mut.sum()))
    plens = np.full(nb, lp, np.int32)
    tlens = np.full(nb, lt, np.int32)
    plens[:3], tlens[3:5] = (0, 1, lp // 3), (0, lt // 2)
    if lp > MYERS_HOLD_LP:
        plens[:MYERS_HOLD] = (lp, 1, 33, lp - 33, 4_097, 2_049, 1_025, 65)
        for b in (0, 3):
            pats[b, 700:3_000] = 0
            texts[b] = np.where(texts[b] == 0, 2, texts[b])
    return pats, plens, texts, tlens


def phase_k6(torch, np, only=None):
    """K6 against its plain version at MYERS_SHAPES (those ``only``
    names, if given), GLOBAL and SEMI_GLOBAL (past MYERS_HOLD_LP on the
    held cut, and SEMI_GLOBAL also at the full shape); each shape driven
    once at full size with the counts reset just before, its tier
    asserted (the warp tier past 8 words) and its launches kept; times
    and bounds by row name."""
    from nvbio_tpu_torch.alignment.myers import myers_edit_distance_batch
    from nvbio_tpu_torch.alignment.types import AlignmentType
    from nvbio_tpu_torch.ops import banded_dp, myers

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for name, (nb, lp, lt) in MYERS_SHAPES.items():
        if only is not None and name not in only:
            continue
        arrays = myers_inputs(np, rng, nb, lp, lt)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        words = (lp + 31) // 32
        sg = AlignmentType.SEMI_GLOBAL
        banded_dp.reset_launch_counts()
        got = myers.myers(*args, atype=sg)  # the phase's call, full shape
        torch.cuda.synchronize()
        launches = myers.myers.launches
        warp = getattr(myers.myers, "warp_launches", None)  # (parent: none)
        if launches != 1 or warp not in (None, int(words > 8)):
            fail(f"K6 at {nb} x {lp}: {launches} launches, {warp} on the "
                 f"warp tier (expected 1, {int(words > 8)})")
        held = args
        if lp > MYERS_HOLD_LP:
            held = [args[0][:MYERS_HOLD], args[1][:MYERS_HOLD],
                    args[2][:MYERS_HOLD, :MYERS_HOLD_LT].contiguous(),
                    args[3][:MYERS_HOLD].clamp(max=MYERS_HOLD_LT)]
        err = 0
        for atype in (AlignmentType.GLOBAL, sg):
            err = max(err, max_abs_err(
                torch, list(myers.myers(*held, atype=atype)),
                list(myers_edit_distance_batch(*held, atype=atype))))
            if err:
                fail(f"K6 differs from its plain version ({atype.name}, "
                     f"{nb} x {lp}): max_abs_err {err}")

        def k6():
            return myers.myers(*args, atype=sg)

        want = []

        def p6():
            want[:] = myers_edit_distance_batch(*args, atype=sg)

        ms = cuda_ms(torch, k6, 10 if lp <= MYERS_HOLD_LP else 3)
        pms = cuda_ms(torch, p6, 1, warm=lp <= MYERS_HOLD_LP)
        # SEMI_GLOBAL on every lane and column of the full shape: the
        # phase's call against the plain version's timed call
        full = max_abs_err(torch, list(got), want)
        if full:
            fail(f"K6 differs from its plain version (SEMI_GLOBAL, {nb} x "
                 f"{lp}, full shape): max_abs_err {full}")
        err = max(err, full)
        cells = nb * lp * lt  # full-matrix cells (sw_benchmark.py:93)
        # the words and columns the function needs, lane by lane
        pl = arrays[1].astype(np.int64)
        cols = np.where(pl > 0, arrays[3].clip(0, lt), 0).astype(np.int64)
        work = int((cols * ((pl + 31) // 32)).sum())
        nbytes = dp_bytes(*args, out_bytes=8 * nb)
        bms, by = bound(MYERS_WORD_OPS * work
                        + MYERS_COL_OPS * int(cols.sum()), nbytes)
        yard = bound(MYERS_YARD_WORD_OPS * work
                     + MYERS_YARD_COL_OPS * int(cols.sum()), nbytes)[0]
        occ = k6_occupancy(nb, lp)
        out[name] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by, "yard_bound_ms": yard,
                     "word_columns": work,
                     "gcups": cells / ms / 1e6,
                     "plain_gcups": cells / pms / 1e6, "max_abs_err": err,
                     "launches": launches, "warp_launches": warp,
                     "occupancy": occ}
        on = ("all lanes" if held is args else
              f"{MYERS_HOLD} lanes of {MYERS_HOLD_LT} columns, SEMI_GLOBAL "
              "also on all lanes")
        log(f"[k6] {name}: {nb} x {lp} bp ({words} words), Lt {lt}: GLOBAL"
            f" and SEMI_GLOBAL bit-identical to the plain version on {on}; "
            f"{occ}; SEMI_GLOBAL kernel {ms:.4f} ms ({cells / ms / 1e6:.1f}"
            f" GCUPS, full-matrix cells), plain {pms:.1f} ms; bound "
            f"{bms:.4f} ms ({by}), share {bms / ms:.3f} (yardstick "
            f"{yard / ms:.3f})")
    return out


def phase_sw_benchmark(torch):
    """sw_benchmark --device cuda --long at its defaults."""
    import contextlib
    import io

    from nvbio_tpu_torch.ops import banded_dp, wavefront_dp
    from nvbio_tpu_torch.tools.sw_benchmark import main as swb

    buf = io.StringIO()
    banded_dp.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = swb(["--device", DEV, "--long"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    sweep = wavefront_dp.wavefront_score.sweep_launches
    rows = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or any(launches[k] < 1 for k in ("K1", "K4", "K5", "K6")):
        fail(f"sw_benchmark --long did not launch K1, K4, K5 and K6: "
             f"rc {rc}, launches {launches}")
    if banded_dp.KERNELS["K6"].warp_launches:  # 100 bp: W = 4
        fail("sw_benchmark --long: a K6 call left the thread tier")
    if sweep != launches["K5"]:  # gotoh_wide's and wide_cigar's pass 1
        fail(f"sw_benchmark --long: {launches['K5'] - sweep} of its "
             f"{launches['K5']} K5 calls missed the banded tier")
    if {r["engine"] for r in rows} != {"cuda"}:
        fail(f"sw_benchmark rows not all on the kernels: {rows}")
    for r in rows:
        log(f"[sw_benchmark] {json.dumps(r)}")
    log(f"[sw_benchmark] --device cuda --long: {secs:.1f}s; launches "
        f"{launches}, {sweep} of K5's on the banded tier")
    return {"rows": rows, "launches": launches, "sweep_launches": sweep,
            "seconds": secs}


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
    from nvbio_tpu_torch.alignment import wide
    from nvbio_tpu_torch.alignment.wide import (TB_BANDS, derive_tb_band,
                                                wide_band_cigar_batch)
    from nvbio_tpu_torch.ops import banded_dp, wavefront_dp

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
    # pass 3's K5 calls timed by CUDA events, its device walks by the host
    # clock (synchronised), inside the run (wide's own names are wrapped:
    # the kernel's function keeps its counters)
    k5_events, walk_s = [], []
    dirs_fn = wavefront_dp.wavefront_dirs
    walk_fn = wide.walk_wavefront_dirs_device

    def timed_dirs(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = dirs_fn(*a, **kw)
        ev[1].record()
        k5_events.append(ev)
        return res

    def timed_walk(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = walk_fn(*a, **kw)
        torch.cuda.synchronize()
        walk_s.append(time.perf_counter() - t)
        return res

    banded_dp.reset_launch_counts()
    torch.cuda.synchronize()
    wide.wavefront_dp = types.SimpleNamespace(wavefront_dirs=timed_dirs)
    wide.walk_wavefront_dirs_device = timed_walk
    try:
        t0 = time.perf_counter()
        out = wide_band_cigar_batch(*args, scheme=scheme,
                                    atype=AlignmentType.SEMI_GLOBAL,
                                    band_w=band_w)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        wide.wavefront_dp = wavefront_dp
        wide.walk_wavefront_dirs_device = walk_fn
    k5_ms = [a.elapsed_time(b) for a, b in k5_events]
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    if dirs_fn.sweep_launches != dirs_fn.launches:
        fail(f"pass 3: {dirs_fn.launches} K5 flag calls, "
             f"{dirs_fn.sweep_launches} of them on the flag tier")
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
        f"D run; {secs * 1e3:.1f} ms (host clock), of which K5 with flags "
        f"{sum(k5_ms):.3f} ms in {len(k5_ms)} call(s) (CUDA events) and the "
        f"device walk {sum(walk_s) * 1e3:.1f} ms (host clock); launches "
        f"{launches}")
    return {"launches": launches, "ms": secs * 1e3, "gaps": gaps.tolist(),
            "need": need.tolist(), "k5_dirs_ms": k5_ms,
            "walk_ms": [t * 1e3 for t in walk_s]}


def sam_records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def se_accuracy(recs, sim):
    """(aligned, correct) shares of SAM records against their simulated
    origins: aligned of the records, correct (the true strand, POS within
    8 bp of the origin) of the aligned."""
    aligned = correct = 0
    for i, ln in enumerate(recs):
        f = ln.split("\t", 4)
        flag, pos = int(f[1]), int(f[3])
        if not flag & 4:
            aligned += 1
            correct += (int(bool(flag & 16)) == int(sim["true_strand"][i])
                        and abs(pos - 1 - int(sim["true_pos"][i])) <= 8)
    return aligned / max(len(recs), 1), correct / max(aligned, 1)


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
    # -S *.bam writes BAM: the same bytes under both devices, @PG aside
    bams = {}
    for dev in (DEV, "cpu"):
        mapr(["-x", f"{d}/g.npz", "-U", f"{d}/r.fq", "-S", f"{d}/{dev}.bam",
              "--device", dev, "--batch", "128"])
        with open(f"{d}/{dev}.bam", "rb") as f:
            raw = f.read()
        if not raw.startswith(b"\x1f\x8b\x08\x04") or not raw.endswith(
                bytes.fromhex("1f8b08040000000000ff0600424302001b00030000"
                              "00000000000000")):
            fail(f"-S {dev}.bam did not write BGZF (magic, EOF block)")
        raw = gzip.decompress(raw)
        n_text = int.from_bytes(raw[4:8], "little")
        text = raw[8:8 + n_text].decode().splitlines(keepends=True)
        bams[dev] = ([ln for ln in text if not ln.startswith("@PG")],
                     raw[8 + n_text:], raw[:4])
    if bams[DEV] != bams["cpu"] or bams[DEV][2] != b"BAM\x01":
        fail("golden -S *.bam: the decompressed BAM under --device cuda "
             "differs from --device cpu's")
    log(f"[golden] -S *.bam: BGZF BAM, decompressed bytes identical under "
        f"--device cuda and --device cpu ({len(bams[DEV][1])} record bytes)")
    return counts


def write_pairs(path1, path2, sim, s2=None, n=None):
    from nvbio_tpu_torch.io.fastq import write_fastq

    s2 = sim["seqs2"] if s2 is None else s2
    n = len(s2) if n is None else n
    write_fastq(path1, [(f"p{i}", sim["seqs1"][i].astype("uint8"),
                         sim["quals1"][i]) for i in range(n)])
    write_fastq(path2, [(f"p{i}", s2[i].astype("uint8"), sim["quals2"][i])
                        for i in range(n)])


def phase_golden_pe(torch):
    """The golden paired-end dataset (made as tests/test_golden.py:42
    makes it) through map_reads -1/-2 --device cuda."""
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_pairs

    d = os.path.join(WORK, "golden_pe")
    os.makedirs(d, exist_ok=True)
    g = random_genome(150_000, seed=777)
    write_fasta(f"{d}/g.fa", [("golden_pe_ref", g)])
    sim = simulate_pairs(g, 120, 100, insert_mean=280, insert_sd=25,
                         error_rate=0.02, seed=778)
    write_pairs(f"{d}/r1.fq", f"{d}/r2.fq", sim)
    build([f"{d}/g.fa", f"{d}/g.npz"])
    banded_dp.reset_launch_counts()
    mapr(["-x", f"{d}/g.npz", "-1", f"{d}/r1.fq", "-2", f"{d}/r2.fq", "-S",
          f"{d}/out.sam", "--device", DEV, "--batch", "128"])
    counts = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    got = [ln for ln in open(f"{d}/out.sam") if not ln.startswith("@PG")]
    want = list(gzip.open(os.path.join(ROOT, "tests", "data",
                                       "golden_pe.sam.gz"), "rt"))
    if got != want:
        n_diff = sum(a != b for a, b in zip(got, want))
        fail(f"golden PE SAM differs under --device cuda ({n_diff} lines, "
             f"{len(got)} vs {len(want)})")
    if not all(counts[k] > 0 for k in ("K2", "K3", "K4")):
        fail(f"golden PE run did not launch K2, K3 and K4: {counts}")
    log(f"[golden_pe] SAM byte-identical to golden_pe.sam.gz under --device "
        f"cuda ({len(got)} lines; launches {counts})")
    return counts


def stage_timer(torch, t):
    """The stage breakdowns' wrapper factory: timed(name, fn) runs fn
    between two device synchronisations and adds its host-clock ms to
    t[name] (``name`` may be a function of the call's arguments)."""
    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            key = name(a) if callable(name) else name
            t[key] = t.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run
    return timed


def pe_stage_breakdown(torch, np, npz, r1_fq, r2_fq, batch=4096):
    """Host-clock ms per stage (synchronised) of full paired-end batches
    through PairedMapper.map_pairs_stream and to_sam_records_pe, as the
    CLI runs them; the median of batches 2-4.  Wrappers time the upload,
    pe_map_batch (and inside it the candidate stage and the two rescue
    calls, the rescue's DP calls with CUDA events) and the per-mate
    tracebacks; the host finish is what is left of the batch."""
    import itertools

    from nvbio_tpu_torch.io.fastq import FastqBatchReader
    from nvbio_tpu_torch.io.index_file import load_index
    from nvbio_tpu_torch.models import paired as P
    from nvbio_tpu_torch.models.params import MapperParams
    from nvbio_tpu_torch.strings.string_set import pack_reads

    dev = torch.device(DEV)
    fm, ssa, genome, meta = load_index(npz, device=dev)
    params = MapperParams(seed_interval_fn="S", seed_interval_a=1.0,
                          seed_interval_b=1.15, batch_size=batch,
                          max_read_len=320, sa_sample=meta["sa_sample"],
                          lut_k=meta["lut_k"])
    m = P.PairedMapper(fm, ssa, genome, params=params, lut=meta["lut"])
    # four batches, read and packed as the CLI's packed_pe does, before
    # any clock starts
    batches = []
    for (names, s1, q1), (_, s2, q2) in itertools.islice(zip(
            FastqBatchReader(r1_fq, batch), FastqBatchReader(r2_fq, batch)),
            4):
        r1, l1, qm1, _ = pack_reads(s1, q1, max_len=320)
        r2, l2, qm2, _ = pack_reads(s2, q2, max_len=320)
        batches.append((names, r1, l1, qm1, r2, l2, qm2))
    t, calls = {}, []
    timed = stage_timer(torch, t)

    def events(name, fn):
        def run(*a, **k):
            calls.append((a[0].shape[0], a[0].shape[1], a[2].shape[1],
                          k["band_w"]))
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            stop.record()
            stop.synchronize()
            t[name] = t.get(name, 0.0) + start.elapsed_time(stop)
            return out
        return run

    cand, resc = "candidate stage, 2R reads (K3)", "rescue, 2 calls (K4)"
    k4ev = "of which the K4 calls (events)"
    tb = "traceback, 2 mates (K2) + walk"
    wrap = {"candidate_stage": timed(cand, P.candidate_stage),
            "_rescue": timed(resc, P._rescue),
            "banded_score": events(k4ev, P.banded_score),
            "pe_map_batch": timed("pe_map_batch", P.pe_map_batch),
            "traceback_walk_batch": timed(tb, P.traceback_walk_batch)}
    saved = {name: getattr(P, name) for name in wrap}
    m._stage_pair_batch = timed("upload", m._stage_pair_batch)
    rows = []
    try:
        for name, fn in wrap.items():
            setattr(P, name, fn)
        stream = m.map_pairs_stream(iter(batches))
        for _ in batches:
            t.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = next(stream)
            recs = m.to_sam_records_pe(*out)
            total = (time.perf_counter() - t0) * 1e3
            assert len(recs) == 2 * len(out[0])
            rows.append({
                "upload": t["upload"], cand: t[cand],
                "pairing + MAPQ": t["pe_map_batch"] - t[cand] - t[resc],
                resc: t[resc], k4ev: t[k4ev], tb: t[tb],
                "host finish + SAM records": (total - t["upload"]
                                              - t["pe_map_batch"] - t[tb]),
                "batch": total})
    finally:
        for name, fn in saved.items():
            setattr(P, name, fn)
    rows = rows[1:] or rows  # the first batch warms the allocator
    return ({k: float(np.median([r[k] for r in rows])) for k in rows[0]},
            sorted(set(calls)))


def phase_pe(torch, np, g):
    """50 000 pairs on the chr20-length index through map_reads -1/-2
    --batch 4096 --device cuda, 5% of them with mate 2's seeds broken."""
    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    d = os.path.join(WORK, "chr20len")
    t0 = time.perf_counter()
    sim, n_flip = pe_inputs(np, g, d, N_PAIRS, PE_CPU)
    log(f"[pe] {N_PAIRS} pairs ({n_flip} with mate 2's seeds "
        f"broken) made in {time.perf_counter() - t0:.1f}s")

    # the paired-end path's run: launch counts from here on are its own
    banded_dp.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mapr(["-x", f"{d}/g.npz", "-1", f"{d}/pe1.fq", "-2", f"{d}/pe2.fq",
          "-S", f"{d}/pe.sam", "--device", DEV, "--batch", "4096",
          "--stats", f"{d}/pe_stats.json"])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    stats = json.load(open(f"{d}/pe_stats.json"))
    recs = sam_records(f"{d}/pe.sam")
    if len(recs) != 2 * N_PAIRS:
        fail(f"{len(recs)} SAM records for {N_PAIRS} pairs")
    if not all(launches[k] > 0 for k in ("K2", "K3", "K4")):
        fail(f"the paired-end run did not launch K2, K3 and K4 (the "
             f"rescue): {launches}")
    if stats["rescued"] < 1:
        fail(f"the paired-end run rescued no pair: {stats}")
    aligned = correct = 0
    for i, ln in enumerate(recs):
        f = ln.split("\t", 4)
        flag, pos = int(f[1]), int(f[3])
        if flag & 4:
            continue
        aligned += 1
        r = i // 2
        start = int(sim["true_pos"][r])
        end = start + int(sim["insert"][r])
        if i % 2 == 0:
            ok = not flag & 16 and abs(pos - 1 - start) <= 8
        else:
            ok = flag & 16 and abs(pos - 1 + 100 - end) <= 8
        correct += bool(ok)
    frac_al = aligned / (2 * N_PAIRS)
    frac_ok = correct / max(aligned, 1)
    proper = stats["proper_pairs"] / N_PAIRS
    rescued = stats["rescued"] / N_PAIRS
    log(f"[pe] map_reads -1/-2 --device cuda --batch 4096: {N_PAIRS} pairs "
        f"in {stats['map_s']:.2f}s = {stats['pairs_per_s']:.0f} pairs/s "
        f"(index load {stats['load_s']:.1f}s not counted); peak "
        f"{peak / 2**30:.2f} GiB; proper {proper:.4f}, rescued "
        f"{rescued:.4f} (rescue_dropped {stats['rescue_dropped']}), "
        f"discordant {stats['discordant']}; mates aligned {frac_al:.4f}, "
        f"correct {frac_ok:.4f} of aligned; launches {launches}")
    if frac_al < 0.95 or frac_ok < 0.90 or proper < 0.90:
        fail(f"paired-end bars missed: aligned {frac_al}, correct "
             f"{frac_ok}, proper {proper}")

    sams = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        mapr(["-x", f"{d}/g.npz", "-1", f"{d}/pe1_cpu.fq", "-2",
              f"{d}/pe2_cpu.fq", "-S", f"{d}/pe_{dev}.sam", "--device", dev,
              "--batch", str(PE_CPU)])
        sams[dev] = (sam_records(f"{d}/pe_{dev}.sam"),
                     time.perf_counter() - t0)
    if sams[DEV][0] != sams["cpu"][0]:
        n_diff = sum(a != b for a, b in zip(sams[DEV][0], sams["cpu"][0]))
        fail(f"paired-end: --device cpu SAM differs from --device cuda on "
             f"the first {PE_CPU} pairs ({n_diff} records)")
    log(f"[pe] first {PE_CPU} pairs with --batch {PE_CPU}: identical SAM "
        f"records under --device cuda ({sams[DEV][1]:.1f}s) and --device "
        f"cpu ({sams['cpu'][1]:.1f}s)")

    stages, calls = pe_stage_breakdown(torch, np, f"{d}/g.npz",
                                       f"{d}/pe1.fq", f"{d}/pe2.fq")
    log("[pe] one 4096-pair batch, ms per stage (synchronised, median of "
        "3): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    # the rescue's DP calls (NB, Lp, Lt, band_w): phase_path_shapes times
    # K4 at rescue_shape(), which must be one of them
    log(f"[pe] the rescue's banded_score calls (NB, Lp, Lt, band_w): {calls}")
    if tuple(rescue_shape()) not in calls:
        fail(f"the rescue's K4 calls {calls} do not include the shape the "
             f"kernel rows time, {rescue_shape()}")
    return {"launches": launches, "peak_bytes": peak, "stats": stats,
            "proper": proper, "rescued": rescued, "aligned": frac_al,
            "correct": frac_ok, "stages_ms": stages, "rescue_calls": calls,
            "cuda_subset_s": sams[DEV][1], "cpu_subset_s": sams["cpu"][1]}


def stage_breakdown(torch, np, npz, reads_fq, batch=4096, max_len=320,
                    band_w=15):
    """Host-clock ms per stage (synchronised) for full batches of a
    real-size run, the median of batches 2-4; and the extension's K3
    calls, (NB, Lp, Lt, band_w, lanes with a pattern) each."""
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
    rows, calls = [], []
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
        k3 = M.banded_score_packed

        def k3_call(pats, plens, *a, **kw):
            calls.append((*pats.shape, pats.shape[1] + 2 * kw["band_w"],
                          kw["band_w"], plens))
            return k3(pats, plens, *a, **kw)

        M.banded_score_packed = k3_call
        try:
            ext = M.extend_candidates(m.fm, m.gwords, all_r, all_q, lens2,
                                      cand, params=p, genome=m.genome)
            t0 = mark(f"extend ({ext_k})", t0)
        finally:
            M.banded_score_packed = k3
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
    return ({k: float(np.median([r[k] for r in rows])) for k in rows[0]},
            [(*c[:4], int((c[4] > 0).sum())) for c in calls])


def chr20_inputs(np, d, n_reads, n_cpu=0):
    """The chr20-length random genome (``d``/g.fa) and ``n_reads``
    simulated 100 bp reads (r.fq; the first ``n_cpu`` also in r_cpu.fq);
    returns (genome, simulation)."""
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads

    os.makedirs(d, exist_ok=True)
    g = random_genome(CHR20_BP, seed=SEED)
    write_fasta(f"{d}/g.fa", [("chr20_random", g)])
    sim = simulate_reads(g, n_reads, 100, error_rate=0.02, indel_rate=0.005,
                         seed=SEED + 1)
    for path, n in ((f"{d}/r.fq", n_reads), (f"{d}/r_cpu.fq", n_cpu)):
        if n:
            write_fastq(path, [
                (f"r{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
                for i in range(n)])
    return g, sim


def pe_inputs(np, g, d, n_pairs, n_cpu=0):
    """``n_pairs`` simulated 2 x 100 bp pairs in ``d``/pe1.fq and pe2.fq
    (the first ``n_cpu`` also in pe1_cpu.fq, pe2_cpu.fq), PE_RESCUE_SHARE
    of them with mate 2's seeds broken; returns (the simulation, how
    many were broken)."""
    from nvbio_tpu_torch.utils.simulate import simulate_pairs

    sim = simulate_pairs(g, n_pairs, 100, insert_mean=280, insert_sd=25,
                         error_rate=0.02, seed=SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    flip = rng.random(n_pairs) < PE_RESCUE_SHARE
    s2 = sim["seqs2"].copy()
    for k in range(4, 100, 12):  # tests/test_paired.py:179
        s2[flip, k] = (s2[flip, k] + 1) % 4
    write_pairs(f"{d}/pe1.fq", f"{d}/pe2.fq", sim, s2)
    if n_cpu:
        write_pairs(f"{d}/pe1_cpu.fq", f"{d}/pe2_cpu.fq", sim, s2, n=n_cpu)
    return sim, int(flip.sum())


def build_shards(d):
    """build_index --shard-bp SHARD_BP --shard-overlap SHARD_OVERLAP
    --procs SHARD_PROCS of ``d``/g.fa into ``d``/sh (4 shards, or fail);
    returns (seconds, [(start, length)] by shard)."""
    from nvbio_tpu_torch.tools.build_index import main as build

    t0 = time.perf_counter()
    build([f"{d}/g.fa", f"{d}/sh", "--sa-sample", "4", "--lut-k", "11",
           "--shard-bp", str(SHARD_BP), "--shard-overlap",
           str(SHARD_OVERLAP), "--procs", str(SHARD_PROCS)])
    build_s = time.perf_counter() - t0
    spans = [(e["start"], e["length"])
             for e in json.load(open(f"{d}/sh.manifest.json"))["shards"]]
    if len(spans) != 4:
        fail(f"--shard-bp {SHARD_BP} made {len(spans)} shards: {spans}")
    return build_s, spans


def phase_real_size(torch, np):
    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    d = os.path.join(WORK, "chr20len")
    t0 = time.perf_counter()
    g, sim = chr20_inputs(np, d, N_READS, CPU_READS)
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
    frac_al, frac_ok = se_accuracy(recs, sim)
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

    stages, k3_calls = stage_breakdown(torch, np, f"{d}/g.npz", f"{d}/r.fq")
    log("[real] one 4096-read batch, ms per stage (synchronised, median "
        "of 3): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    # the K3_path row (phase_path_shapes) times the extension's call:
    # its shape must be the real calls', its pattern lanes within a
    # fifth of theirs (the median of the four batches)
    log(f"[real] the extension's K3 calls (NB, Lp, Lt, band_w, lanes with "
        f"a pattern): {k3_calls}")
    shape = (K3_PATH_NB, LP, LP + 2 * BAND_W, BAND_W)
    live = float(np.median([c[4] for c in k3_calls]))
    if ({c[:4] for c in k3_calls} != {shape}
            or abs(K3_PATH_LIVE - live) > 0.2 * live):
        fail(f"the extension's K3 calls {k3_calls} differ from the K3_path "
             f"row's {shape} with {K3_PATH_LIVE} lanes with a pattern")
    return {"build_s": build_s, "launches": launches, "peak_bytes": peak,
            "aligned": frac_al, "correct": frac_ok, "stats": stats,
            "cpu_subset_s": cpu_s, "stages_ms": stages,
            "k3_calls": k3_calls}, g, sim


def run_captured(fn, *args, **kw):
    """``fn(*args, **kw)`` with its stdout and stderr captured: (what it
    returned, host seconds, the captured text); the text is logged
    after."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        ret = fn(*args, **kw)
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    log(text.rstrip())
    return ret, dt, text


def npz_diff(np, got, want):
    """Keys of two .npz files whose arrays differ (or exist in one)."""
    with np.load(got) as a, np.load(want) as b:
        keys = set(a.files) | set(b.files)
        return sorted(k for k in keys if k not in a.files
                      or k not in b.files or a[k].dtype != b[k].dtype
                      or not np.array_equal(a[k], b[k]))


def phase_sufsort(torch, np, g):
    """The index build on the card: build_index --algorithm device at
    E. coli's length (whole-text doubling) against an SA-IS build;
    --algorithm device --device-occ on the chr20-length genome (the
    bucketed sort and the device occ tables) against the real-size
    phase's g.npz; suffix_array_bucketed on a repeat-structured text
    (at least one compacted doubling round) against SA-IS; set_bwt of
    the short-read run's reads on cuda against cpu.  Host-clock seconds
    (the functions return numpy, so they synchronise), SA-IS on the
    same texts in the same process, peak device bytes."""
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import read_fastq_packed
    from nvbio_tpu_torch.native import sais_native
    from nvbio_tpu_torch.sufsort import (suffix_array_bucketed,
                                         suffix_array_device)
    from nvbio_tpu_torch.sufsort import set_bwt_device
    from nvbio_tpu_torch.sufsort.bucketed import _host_bucket_keys
    from nvbio_tpu_torch.tools import build_index
    from nvbio_tpu_torch.tools.set_bwt import main as set_bwt
    from nvbio_tpu_torch.utils.simulate import (random_genome,
                                                repeat_structured_genome)

    d = os.path.join(WORK, "chr20len")
    out = {}

    def timed(fn, *a, **k):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        return r, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    def cli_sort_s(args):
        """build_index(args) captured, with its suffix sort timed
        unrounded: (build seconds, sort seconds, captured text)."""
        sort_s = []

        def timed_sort(*a):
            t0 = time.perf_counter()
            sa = sort(*a)
            sort_s.append(time.perf_counter() - t0)
            return sa

        sort = build_index.suffix_sort
        build_index.suffix_sort = timed_sort
        try:
            _, build_s, text = run_captured(build_index.main, args)
        finally:
            build_index.suffix_sort = sort
        if "suffix sort (device): " not in text or len(sort_s) != 1:
            fail("build_index printed no 'suffix sort (device)' line")
        return build_s, sort_s[0], text

    # 1. whole-text device doubling at E. coli's length
    e = random_genome(ECOLI_BP, seed=SEED + 40)
    write_fasta(f"{d}/ecoli.fa", [("ecoli_random", e)])
    sa_host, host_s, _ = timed(sais_native, e)
    suffix_array_device(e[:100_000], DEV)  # warm the sort's first call
    sa_dev, dev_s, peak = timed(suffix_array_device, e, DEV)
    if not np.array_equal(sa_dev, sa_host):
        fail("suffix_array_device differs from SA-IS at E. coli's length")
    build_dev_s, cli_s, text = cli_sort_s([
        f"{d}/ecoli.fa", f"{d}/ecoli_dev.npz", "--algorithm", "device",
        "--device", DEV, "--sa-sample", "4", "--lut-k", "11"])
    _, build_sais_s, _ = run_captured(build_index.main, [
        f"{d}/ecoli.fa", f"{d}/ecoli.npz", "--algorithm", "sais",
        "--sa-sample", "4", "--lut-k", "11"])
    if "[sufsort] chunk" in text:
        fail("build_index --algorithm device took the bucketed sort at "
             f"{ECOLI_BP} bp")
    bad = npz_diff(np, f"{d}/ecoli_dev.npz", f"{d}/ecoli.npz")
    if bad:
        fail(f"--algorithm device .npz differs from SA-IS's in {bad}")
    out["ecoli"] = {"bp": ECOLI_BP, "device_s": dev_s, "sais_s": host_s,
                    "device_mbp_s": ECOLI_BP / dev_s / 1e6,
                    "sais_mbp_s": ECOLI_BP / host_s / 1e6,
                    "peak_bytes": peak, "cli_sort_s": cli_s,
                    "build_device_s": build_dev_s,
                    "build_sais_s": build_sais_s}
    log(f"[sufsort] {ECOLI_BP} bp: suffix_array_device {dev_s:.3f}s "
        f"({ECOLI_BP / dev_s / 1e6:.1f} Mbp/s, peak {peak / 2**20:.0f} "
        f"MiB) vs SA-IS {host_s:.3f}s ({ECOLI_BP / host_s / 1e6:.1f} "
        f"Mbp/s); build_index --algorithm device {build_dev_s:.1f}s vs "
        f"sais {build_sais_s:.1f}s; every .npz array equal")
    del e, sa_host, sa_dev

    # 2. the bucketed sort and the device occ tables at chr20's length
    torch.cuda.reset_peak_memory_stats()
    build_s, sort_s, text = cli_sort_s([
        f"{d}/g.fa", f"{d}/g_dev.npz", "--algorithm", "device",
        "--device-occ", "--device", DEV, "--sa-sample", "4",
        "--lut-k", "11"])
    peak = torch.cuda.max_memory_allocated()
    n_chunks = text.count("[sufsort] chunk")
    if not n_chunks:
        fail("build_index --algorithm device ran no bucketed chunk at "
             f"{len(g)} bp")
    bad = npz_diff(np, f"{d}/g_dev.npz", f"{d}/g.npz")
    if bad:
        fail(f"--algorithm device --device-occ .npz differs from the "
             f"SA-IS build's in {bad}")
    _, host_s, _ = timed(sais_native, g)
    # the bucketed sort's host bucketing alone: the 8-symbol keys and
    # their stable argsort, and the same order from one np.sort of
    # (key << 32 | position), unique int64s
    t0 = time.perf_counter()
    key8 = _host_bucket_keys(g)
    keys_s = time.perf_counter() - t0
    order = np.argsort(key8, kind="stable")
    argsort_s = time.perf_counter() - t0 - keys_s
    t0 = time.perf_counter()
    by_sort = np.sort((key8.astype(np.int64) << 32)
                      | np.arange(len(g), dtype=np.int64)) & 0xFFFFFFFF
    packed_s = time.perf_counter() - t0
    if not np.array_equal(by_sort, order):
        fail("np.sort of (key << 32 | position) gives another order than "
             "the stable argsort")
    del key8, order, by_sort
    out["chr20"] = {"bp": len(g), "cli_sort_s": sort_s,
                    "device_mbp_s": len(g) / sort_s / 1e6,
                    "sais_s": host_s, "sais_mbp_s": len(g) / host_s / 1e6,
                    "build_s": build_s, "chunks": n_chunks,
                    "peak_bytes": peak, "host_keys_s": keys_s,
                    "host_argsort_s": argsort_s,
                    "host_packed_sort_s": packed_s}
    log(f"[sufsort] {len(g)} bp: bucketed device sort {sort_s:.1f}s "
        f"({len(g) / sort_s / 1e6:.2f} Mbp/s, {n_chunks} chunks run) vs "
        f"SA-IS {host_s:.1f}s ({len(g) / host_s / 1e6:.2f} Mbp/s); "
        f"build_index --algorithm device --device-occ {build_s:.1f}s, "
        f"peak {peak / 2**20:.0f} MiB; every .npz array equal to g.npz's; "
        f"its host bucketing alone: keys {keys_s:.2f}s + stable argsort "
        f"{argsort_s:.2f}s (np.sort of packed (key, position) "
        f"{packed_s:.2f}s, the same order)")

    # 3. repeats: the compacted doubling
    t = repeat_structured_genome(REPEATS_BP, seed=SEED + 41)[0]
    torch.cuda.reset_peak_memory_stats()
    sa_dev, dev_s, text = run_captured(suffix_array_bucketed, t,
                                       verbose=True, device=DEV)
    peak = torch.cuda.max_memory_allocated()
    n_chunks = text.count("[sufsort] chunk")
    n_double = text.count("[sufsort] doubling")
    sa_host, host_s, _ = timed(sais_native, t)
    if not np.array_equal(sa_dev, sa_host):
        fail("suffix_array_bucketed differs from SA-IS on the "
             "repeat-structured text")
    if n_double < 1:
        fail("the repeat-structured text ran no compacted doubling round")
    out["repeats"] = {"bp": REPEATS_BP, "device_s": dev_s, "sais_s": host_s,
                      "device_mbp_s": REPEATS_BP / dev_s / 1e6,
                      "sais_mbp_s": REPEATS_BP / host_s / 1e6,
                      "chunks": n_chunks, "doubling_rounds": n_double,
                      "peak_bytes": peak}
    log(f"[sufsort] {REPEATS_BP} bp repeat-structured: bucketed {dev_s:.1f}s "
        f"({REPEATS_BP / dev_s / 1e6:.2f} Mbp/s; {n_chunks} chunks, "
        f"{n_double} doubling rounds, peak {peak / 2**20:.0f} MiB) vs SA-IS "
        f"{host_s:.1f}s; equal")
    del t, sa_dev, sa_host

    # 4. the set-BWT of the short-read run's reads: the CLI on cuda and
    # on cpu, and the function alone on the card
    _, cli_s, text = run_captured(set_bwt, [
        f"{d}/r.fq", f"{d}/bwt_gpu.npy", "--max-len", "100", "--device",
        DEV])
    _, cpu_s, _ = run_captured(set_bwt, [
        f"{d}/r.fq", f"{d}/bwt_cpu.npy", "--max-len", "100", "--device",
        "cpu"])
    bwt = np.load(f"{d}/bwt_gpu.npy")
    if not np.array_equal(bwt, np.load(f"{d}/bwt_cpu.npy")):
        fail("set_bwt --device cuda differs from --device cpu")
    _, reads, lens, _ = read_fastq_packed(f"{d}/r.fq", max_len=100)
    reads = np.where(reads < 4, reads, 0).astype(np.uint8)
    live = np.arange(reads.shape[1])[None, :] < lens[:, None]
    want = np.append(np.bincount(reads[live], minlength=4), len(lens))
    got = np.bincount(bwt, minlength=5)
    if not np.array_equal(got, want):
        fail(f"set-BWT symbol counts {got} != the reads' {want}")
    again, dev_s, peak = timed(set_bwt_device, reads, lens, DEV)
    if not np.array_equal(again, bwt):
        fail("set_bwt_device differs from the set_bwt CLI's output")
    n_bases = int(lens.sum())
    out["set_bwt"] = {"reads": len(lens), "bases": n_bases,
                      "suffixes": len(bwt), "device_s": dev_s,
                      "mbases_s": n_bases / dev_s / 1e6, "cli_s": cli_s,
                      "cli_cpu_s": cpu_s, "peak_bytes": peak}
    log(f"[sufsort] set_bwt: {len(lens)} reads, {len(bwt)} suffixes; "
        f"set_bwt_device {dev_s:.3f}s ({n_bases / dev_s / 1e6:.1f} "
        f"Mbases/s, peak {peak / 2**20:.0f} MiB); the CLI (FASTQ read and "
        f".npy write included) cuda {cli_s:.1f}s, cpu {cpu_s:.1f}s; equal; "
        f"A C G T $ counts {got.tolist()}")
    return out


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

    stages, _ = stage_breakdown(torch, np, f"{d}/g.npz", f"{d}/long.fq",
                                batch=1024, max_len=2048, band_w=LONG_W)
    log("[long] one 1024-read batch, ms per stage (synchronised, median "
        "of 3): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    return {"launches": launches, "peak_bytes": peak, "aligned": frac_al,
            "correct": frac_ok, "stats": stats, "stages_ms": stages,
            "cuda_subset_s": sams[DEV][1], "cpu_subset_s": sams["cpu"][1]}


def capture(torch, module, name, calls, kept):
    """Wrap the kernel wrapper ``module.name`` (the attribute its path
    calls it by) for one run: each call logs (NB, Lp, Lt, band_w) and its
    lanes with a pattern (a device tensor, read after the run) into
    ``calls``, and the first call's arguments go to ``kept`` (per-lane
    tensors cloned).  Returns the function that restores the wrapper."""
    fn = getattr(module, name)

    def run(*a, **kw):
        pats = a[0]
        nb = pats.shape[0]
        lt = (a[2].shape[1] if a[2].dim() == 2
              else pats.shape[1] + 2 * kw["band_w"])  # K3: packed words
        calls.append((nb, pats.shape[1], lt, kw["band_w"], (a[1] > 0).sum()))
        if not kept:
            kept.append(([x.clone() if isinstance(x, torch.Tensor)
                          and x.dim() and x.shape[0] == nb else x
                          for x in a], dict(kw)))
        return fn(*a, **kw)

    setattr(module, name, run)
    return lambda: setattr(module, name, fn)


def mode_run(torch, npz, inputs, sam, flags, wraps=(), tool=None):
    """map_reads (or the CLI ``tool``, a main() taking map_reads' -x, -S,
    --device, --batch and --stats) --device cuda --batch 4096 ``flags``
    on ``inputs`` (-U or -1/-2 files), the launch counts reset just
    before and read just after; ``wraps`` = (module, wrapper name,
    kernel) to capture().  Returns (launches, --stats JSON, calls and
    kept arguments by kernel)."""
    from nvbio_tpu_torch.ops import banded_dp
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    mapr = tool or mapr

    calls, kept, undo = {}, {}, []
    for module, name, kernel in wraps:
        calls[kernel], kept[kernel] = [], []
        undo.append(capture(torch, module, name, calls[kernel],
                            kept[kernel]))
    try:
        banded_dp.reset_launch_counts()
        mapr(["-x", npz, *inputs, "-S", sam, "--device", DEV, "--batch",
              "4096", "--stats", f"{sam}.json", *flags])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    finally:
        for u in undo:
            u()
    calls = {k: [(*c[:4], int(c[4])) for c in v] for k, v in calls.items()}
    return launches, json.load(open(f"{sam}.json")), calls, kept


def same_sam(npz, inputs, sam, flags, batch, tag, tool=None):
    """The SAM records of ``inputs`` mapped under --device cuda and
    --device cpu at --batch ``batch`` by map_reads (or the CLI
    ``tool``): identical, or fail.  Returns (records, seconds by
    device)."""
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    mapr = tool or mapr

    recs, secs = {}, {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        mapr(["-x", npz, *inputs, "-S", f"{sam}.{dev}", "--device", dev,
              "--batch", str(batch), *flags])
        secs[dev] = time.perf_counter() - t0
        recs[dev] = sam_records(f"{sam}.{dev}")
    if recs[DEV] != recs["cpu"]:
        n_diff = sum(a != b for a, b in zip(recs[DEV], recs["cpu"]))
        fail(f"{tag}: --device cpu SAM differs from --device cuda "
             f"({n_diff} of {len(recs[DEV])} records)")
    log(f"[{tag}] {' '.join([*flags, *inputs[1::2]])} at --batch "
        f"{batch}: identical SAM records under --device cuda "
        f"({secs[DEV]:.1f}s) and --device cpu ({secs['cpu']:.1f}s)")
    return recs[DEV], secs


def hold_call(torch, tag, kernel, kept, reps=10):
    """A kernel against its plain version on one call a path made (the
    arguments capture() kept), bit for bit (K2's walks too); CUDA-event
    times of both, queued, and the bound over the call's needed cells.
    These launches are not the path's."""
    from nvbio_tpu_torch.alignment.batched import (banded_directions_batch,
                                                   banded_score_batch)
    from nvbio_tpu_torch.ops import banded_dp

    if not kept:
        fail(f"[{tag}] the path made no {kernel} call to hold")
    a, kw = kept[0]
    wrapper, plain, dirs = {
        "K2": (banded_dp.banded_directions, banded_directions_batch, True),
        "K3": (banded_dp.banded_score_packed,
               banded_dp.banded_score_packed_plain, False),
        "K4": (banded_dp.banded_score, banded_score_batch, False)}[kernel]
    banded_dp.reset_launch_counts()
    got, want = wrapper(*a, **kw), plain(*a, **kw)
    torch.cuda.synchronize()
    if banded_dp.KERNELS[kernel].launches != 1:
        fail(f"[{tag}] the call did not launch {kernel}: "
             f"{ {k: f.launches for k, f in banded_dp.KERNELS.items()} }")
    keys = ("score", "p_end", "t_end")
    w = kw["band_w"]
    if dirs:
        (r, d), (wr, wd) = got, want
        err = max(max_abs_err(torch, [r[k] for k in keys] + [d],
                              [wr[k] for k in keys] + [wd]),
                  max_abs_err(torch, walk_outputs(torch, r, d, w),
                              walk_outputs(torch, wr, wd, w)))
        want = wr
    else:
        err = max_abs_err(torch, [got[k] for k in keys],
                          [want[k] for k in keys])
    if err:
        fail(f"[{tag}] {kernel} differs from its plain version on the "
             f"path's call: max_abs_err {err}")
    ms = cuda_ms(torch, lambda: wrapper(*a, **kw), reps)
    pms = cuda_ms(torch, lambda: plain(*a, **kw), 1)
    pats, plens = a[0], a[1]
    nb, lp = pats.shape
    tlens = a[4] if kernel == "K3" else a[3]
    lt = lp + 2 * w if kernel == "K3" else a[2].shape[1]
    cells = band_cells(torch, plens, tlens, w)
    lanes = [x for x in a if isinstance(x, torch.Tensor) and x.dim()
             and x.shape[0] == nb]
    # K3 reads its windows' packed words, not the whole genome
    nbytes = dp_bytes(*lanes, out_bytes=12 * nb) + (
        nb * (lt // 16 + 2) * 4 if kernel == "K3" else 0) + (
        nb * lp * (2 * w + 1) if dirs else 0)
    bms, by, yard = gotoh_bound(cells, nbytes, dirs)
    live = int((plens > 0).sum())
    n_ok = int((want["score"] > -(1 << 29)).sum())
    log(f"[{tag}] {kernel}{' with flags' if dirs else ''} on the path's "
        f"call, {kw['atype'].name}: {nb} x {lp} (Lt {lt}, {live} lanes with"
        f" a pattern, {n_ok} with a path), band_w {w}: bit-identical to the "
        f"plain version{' (walks too)' if dirs else ''}; {ms:.4f} ms queued"
        f" ({cells / ms / 1e6:.1f} GCUPS), bound {bms:.4f} ms ({by}), share "
        f"{bms / ms:.3f}, plain {pms:.2f} ms")
    return {"kernel": kernel, "shape": [nb, lp, lt], "band_w": w,
            "atype": kw["atype"].name, "live": live, "with_path": n_ok,
            "dirs": dirs, "ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "yard_bound_ms": yard, "cells": cells,
            "max_abs_err": err}


def lead_clip(cigar):
    """Length of a CIGAR's leading soft clip (0 without one)."""
    i = 0
    while i < len(cigar) and cigar[i].isdigit():
        i += 1
    return int(cigar[:i]) if i < len(cigar) and cigar[i] == "S" else 0


def mode_reads(np, sim):
    """The first N_MODE_BATCHES batches of the short-read run's reads,
    and their first MODE_SUB, as FASTQ (written once)."""
    from nvbio_tpu_torch.io.fastq import write_fastq

    d = os.path.join(WORK, "chr20len")
    if not os.path.exists(f"{d}/modes.fq"):
        recs = [(f"r{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
                for i in range(N_MODE_BATCHES * 4096)]
        write_fastq(f"{d}/modes.fq", recs)
        write_fastq(f"{d}/modes_sub.fq", recs[:MODE_SUB])
    return d


def phase_local(torch, np, sim):
    """The short-read run's 100 000 reads through map_reads --local."""
    from nvbio_tpu_torch.models import mapper as M

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "chr20len")
    launches, stats, calls, kept = mode_run(
        torch, f"{d}/g.npz", ["-U", f"{d}/r.fq"], f"{d}/local.sam",
        ["--local"], wraps=((M, "banded_score_packed", "K3"),
                            (M, "banded_directions", "K2")))
    if not (launches["K2"] > 0 and launches["K3"] > 0):
        fail(f"the --local run did not launch K2 and K3: {launches}")
    recs = sam_records(f"{d}/local.sam")
    if len(recs) != N_READS:
        fail(f"--local: {len(recs)} SAM records for {N_READS} reads")
    aligned = correct = clipped = 0
    for i, ln in enumerate(recs):
        f = ln.split("\t", 6)
        flag, pos, cigar = int(f[1]), int(f[3]), f[5]
        if flag & 4:
            continue
        aligned += 1
        lead = lead_clip(cigar)
        clipped += lead > 0 or cigar.endswith("S")
        if (int(bool(flag & 16)) == int(sim["true_strand"][i])
                and abs(pos - 1 - lead - int(sim["true_pos"][i])) <= 8):
            correct += 1
    frac_al, frac_ok = aligned / N_READS, correct / max(aligned, 1)
    log(f"[local] map_reads --local --device cuda --batch 4096: {N_READS} "
        f"reads in {stats['map_s']:.2f}s = {stats['reads_per_s']:.0f} "
        f"reads/s; aligned {frac_al:.4f}, within 8 bp of the origin (POS "
        f"less the leading soft clip) {frac_ok:.4f} of aligned, soft-clipped"
        f" {clipped}; launches {launches}; K3 calls (NB, Lp, Lt, band_w, "
        f"lanes with a pattern) {calls['K3'][:3]}..., K2 calls "
        f"{sorted(set(c[:4] for c in calls['K2']))}")
    if frac_al < 0.95 or frac_ok < 0.90:
        fail(f"--local accuracy bars missed: aligned {frac_al}, correct "
             f"{frac_ok}")
    t0 = time.perf_counter()
    from nvbio_tpu_torch.tools.map_reads import main as mapr
    mapr(["-x", f"{d}/g.npz", "-U", f"{d}/r_cpu.fq", "-S",
          f"{d}/local_cpu.sam", "--device", "cpu", "--batch", "4096",
          "--local"])
    cpu_s = time.perf_counter() - t0
    if sam_records(f"{d}/local_cpu.sam") != recs[:CPU_READS]:
        fail(f"--local: --device cpu SAM differs from --device cuda on the "
             f"first {CPU_READS} reads")
    log(f"[local] first {CPU_READS} reads re-mapped with --device cpu: "
        f"identical SAM records ({cpu_s:.1f}s)")
    rows = {"K3_local": hold_call(torch, "local", "K3", kept["K3"]),
            "K2_local": hold_call(torch, "local", "K2", kept["K2"])}
    secs = time.perf_counter() - t_phase
    log(f"[local] phase {secs:.1f}s")
    return {"launches": launches, "stats": stats, "aligned": frac_al,
            "correct": frac_ok, "soft_clipped": clipped, "cpu_subset_s": cpu_s,
            "k3_calls": calls["K3"], "rows": rows, "seconds": secs}


#: one substitution inside every seed of a 100 bp read at the CLI's
#: defaults (-L 22, -i S,1,1.15 = 13: seeds at 0, 13, ..., 78), each in
#: the part of its seed no neighbour overlaps
PLANTED_SUBS = (5, 23, 36, 49, 62, 75, 90)


def phase_n1(torch, np, g, sim):
    """-N 1 on N_MODE_BATCHES batches of the short-read run's reads, and
    on planted reads no exact seed places."""
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    t_phase = time.perf_counter()
    d = mode_reads(np, sim)
    n = N_MODE_BATCHES * 4096
    launches, stats, calls, kept = mode_run(
        torch, f"{d}/g.npz", ["-U", f"{d}/modes.fq"], f"{d}/n1.sam",
        ["-N", "1"], wraps=((M, "banded_score_packed", "K3"),))
    if not (launches["K2"] > 0 and launches["K3"] > 0):
        fail(f"the -N 1 run did not launch K2 and K3: {launches}")
    recs = sam_records(f"{d}/n1.sam")
    frac_al, frac_ok = se_accuracy(recs, sim)
    log(f"[n1] map_reads -N 1 --device cuda --batch 4096: {n} reads in "
        f"{stats['map_s']:.2f}s = {stats['reads_per_s']:.0f} reads/s; "
        f"aligned {frac_al:.4f}, correct {frac_ok:.4f} of aligned; "
        f"escalated {stats['escalated']}, locate_dropped "
        f"{stats['locate_dropped']}; launches {launches}; K3 calls (NB, Lp, "
        f"Lt, band_w, lanes with a pattern): {calls['K3']}")
    if len(recs) != n or frac_al < 0.95 or frac_ok < 0.90:
        fail(f"-N 1 bars missed: {len(recs)} records, aligned {frac_al}, "
             f"correct {frac_ok}")
    same_sam(f"{d}/g.npz", ["-U", f"{d}/modes_sub.fq"], f"{d}/n1_sub.sam",
             ["-N", "1"], MODE_SUB, "n1")

    # reads with one substitution in every seed: -N 0 places none
    rng = np.random.default_rng(SEED + 4)
    starts = rng.integers(0, len(g) - 100, 4096)
    seqs = g[starts[:, None] + np.arange(100)].astype(np.uint8)
    for p in PLANTED_SUBS:
        seqs[:, p] = (seqs[:, p] + 1 + rng.integers(0, 3, 4096)) % 4
    write_fastq(f"{d}/planted.fq", [
        (f"p{i}", seqs[i], np.full(100, 35, np.uint8)) for i in range(4096)])
    placed = {}
    for mm in ("0", "1"):
        mapr(["-x", f"{d}/g.npz", "-U", f"{d}/planted.fq", "-S",
              f"{d}/planted{mm}.sam", "--device", DEV, "--batch", "4096",
              "-N", mm])
        placed[mm] = [0, 0]
        for i, ln in enumerate(sam_records(f"{d}/planted{mm}.sam")):
            f = ln.split("\t", 4)
            if not int(f[1]) & 4:
                placed[mm][0] += 1
                placed[mm][1] += int(int(f[3]) - 1 == starts[i])
    log(f"[n1] 4096 planted reads, one substitution in each of the 7 seeds"
        f": -N 0 aligned {placed['0'][0]}; -N 1 aligned {placed['1'][0]}, "
        f"at their origin {placed['1'][1]}")
    if placed["0"][0] or placed["1"][1] < 0.90 * 4096:
        fail(f"-N 1 planted check missed: {placed}")
    rows = {"K3_n1": hold_call(torch, "n1", "K3", kept["K3"])}
    secs = time.perf_counter() - t_phase
    log(f"[n1] phase {secs:.1f}s")
    return {"launches": launches, "stats": stats, "aligned": frac_al,
            "correct": frac_ok, "planted": placed, "k3_calls": calls["K3"],
            "rows": rows, "seconds": secs}


def phase_all(torch, np, sim):
    """-a --max-alns 8 on N_MODE_BATCHES batches of the short-read run's
    reads, and on a small genome with a planted duplicate segment."""
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr
    from nvbio_tpu_torch.utils.simulate import random_genome

    t_phase = time.perf_counter()
    d = mode_reads(np, sim)
    n = N_MODE_BATCHES * 4096
    flags = ["-a", "--max-alns", "8"]
    launches, stats, calls, kept = mode_run(
        torch, f"{d}/g.npz", ["-U", f"{d}/modes.fq"], f"{d}/all.sam", flags,
        wraps=((M, "banded_directions", "K2"),))
    if not (launches["K2"] > 0 and launches["K3"] > 0):
        fail(f"the -a run did not launch K2 and K3: {launches}")
    recs = sam_records(f"{d}/all.sam")
    primary = sum(not int(ln.split("\t", 2)[1]) & 0x100 for ln in recs)
    log(f"[all] map_reads -a --max-alns 8 --device cuda --batch 4096: {n} "
        f"reads in {stats['map_s']:.2f}s = {stats['reads_per_s']:.0f} "
        f"reads/s; {len(recs)} records, {primary} primary, aligned "
        f"{stats['aligned'] / n:.4f}; launches {launches}; K2 calls (NB, "
        f"Lp, Lt, band_w, lanes with a pattern): {calls['K2']}")
    if primary != n or stats["aligned"] < 0.95 * n:
        fail(f"-a: {primary} primary records for {n} reads, "
             f"{stats['aligned']} aligned")
    if {c[:4] for c in calls["K2"]} != {(8 * 4096, LP, LP + 2 * BAND_W,
                                          BAND_W)}:
        fail(f"-a: K2 calls {calls['K2']} are not 8 x 4096 winners")
    same_sam(f"{d}/g.npz", ["-U", f"{d}/modes_sub.fq"], f"{d}/all_sub.sam",
             flags, MODE_SUB, "all")

    # a planted duplicate: every read reports both loci
    dd = os.path.join(WORK, "dup")
    os.makedirs(dd, exist_ok=True)
    gd = random_genome(40_000, seed=55)
    gd[30_000:30_200] = gd[5_000:5_200]
    write_fasta(f"{dd}/g.fa", [("dup_ref", gd)])
    rng = np.random.default_rng(56)
    offs = rng.integers(0, 120, 256)
    write_fastq(f"{dd}/r.fq", [
        (f"d{i}", gd[5_000 + o:5_080 + o].astype(np.uint8),
         np.full(80, 35, np.uint8)) for i, o in enumerate(offs)])
    build([f"{dd}/g.fa", f"{dd}/g.npz"])
    mapr(["-x", f"{dd}/g.npz", "-U", f"{dd}/r.fq", "-S", f"{dd}/all.sam",
          "--device", DEV, *flags])
    by_read = {}
    for ln in sam_records(f"{dd}/all.sam"):
        f = ln.split("\t", 4)
        by_read.setdefault(f[0], []).append((int(f[1]), int(f[3])))
    # the first record of a read is its primary, every other one is
    # mapped and carries FLAG 0x100
    bad = [i for i, o in enumerate(offs)
           if {5_001 + o, 30_001 + o} - {p for _, p in by_read[f"d{i}"]}
           or by_read[f"d{i}"][0][0] & 0x104
           or any(fl & 0x104 != 0x100 for fl, _ in by_read[f"d{i}"][1:])]
    log(f"[all] planted duplicate (40 kb genome, 200 bp copied 25 kb on): "
        f"{len(offs) - len(bad)} of {len(offs)} reads report both loci, one"
        f" primary record and FLAG 0x100 on every other")
    if bad:
        fail(f"-a planted duplicate: reads {bad[:8]} miss a locus or a flag")
    rows = {"K2_all": hold_call(torch, "all", "K2", kept["K2"])}
    secs = time.perf_counter() - t_phase
    log(f"[all] phase {secs:.1f}s")
    return {"launches": launches, "stats": stats, "records": len(recs),
            "k2_calls": calls["K2"], "rows": rows, "seconds": secs}


def mem_stage_breakdown(torch, np, npz, reads_fq, batch=4096):
    """Host-clock ms per stage (synchronised) of a MemMapper's full
    batches through its own map_stream and to_sam_records, as mem_map
    runs them; the median of batches 2-4.  Wrappers time the upload, the
    strands, the SMEM search, the locate, the extension (K3), the top-2
    and the traceback (K2) + walk; top-K + expansion is the rest of the
    forward step, the host finish what is left of the batch."""
    import itertools

    from nvbio_tpu_torch.io.index_file import load_index
    from nvbio_tpu_torch.io.sequence import ReadBatchIterator
    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.models import mem_mapper as MM
    from nvbio_tpu_torch.models.params import MapperParams
    from nvbio_tpu_torch.strings.string_set import pack_reads

    fm, ssa, genome, meta = load_index(npz, device=torch.device(DEV))
    m = MM.MemMapper(fm, ssa, genome, params=MapperParams(
        batch_size=batch, sa_sample=meta["sa_sample"]))
    batches = []
    for names, seqs, quals in itertools.islice(
            ReadBatchIterator(reads_fq, batch), 4):
        reads, lens, qmat, _ = pack_reads(seqs, quals)
        batches.append((names, reads, lens, qmat))
    t = {}
    timed = stage_timer(torch, t)
    wrap = {(MM, "both_strands"): "strands",
            (MM, "find_mems"): "SMEM search",
            (MM, "locate"): "locate",
            (MM, "extend_candidates"): "extend (K3)",
            (MM, "top2_finish"): "top2+mapq",
            (M, "traceback_walk_batch"): "traceback (K2)+walk"}
    saved = {key: getattr(*key) for key in wrap}
    m._upload = timed("upload", m._upload)
    m._forward = timed("forward", m._forward)
    rows = []
    try:
        for (mod, name), label in wrap.items():
            setattr(mod, name, timed(label, saved[(mod, name)]))
        stream = m.map_stream(iter(batches))
        for _ in batches:
            t.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            names, seqs, lens, quals, results = next(stream)
            recs = m.to_sam_records(names, seqs, lens, quals, results)
            total = (time.perf_counter() - t0) * 1e3
            assert len(recs) == len(names)
            fwd = t.pop("forward")
            row = dict(t, **{"top-K + expansion": fwd - sum(
                t[k] for k in ("strands", "SMEM search", "locate",
                               "extend (K3)", "top2+mapq"))})
            row["host finish+SAM records"] = total - sum(row.values())
            row["batch"] = total
            rows.append(row)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    rows = rows[1:] or rows  # the first batch warms the allocator
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def phase_mem_qmap(torch, np, sim):
    """The MEM and q-gram mappers over the short-read run's 100 000 reads
    on the chr20-length index: mem_map, then qmap, --device cuda --batch
    4096 --stats, each with the counts reset just before and read just
    after; K2 and K3 launched and held against their plain versions on a
    call each run made; the accuracy bars; 1024 reads under both
    devices; a stage breakdown of one mem_map batch."""
    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.models import qgram_mapper as QM
    from nvbio_tpu_torch.tools.mem_map import main as mem_map
    from nvbio_tpu_torch.tools.qmap import main as qmap

    t_phase = time.perf_counter()
    d = mode_reads(np, sim)
    build_ms = {}
    qbuild = QM.build_qgram_index
    out, rows = {}, {}
    for tag, tool in (("mem_map", mem_map), ("qmap", qmap)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build_ms.clear()
        QM.build_qgram_index = stage_timer(torch, build_ms)("build", qbuild)
        try:
            launches, stats, calls, kept = mode_run(
                torch, f"{d}/g.npz", ["-U", f"{d}/r.fq"], f"{d}/{tag}.sam",
                [], wraps=((M, "banded_score_packed", "K3"),
                           (M, "banded_directions", "K2")), tool=tool)
        finally:
            QM.build_qgram_index = qbuild
        peak = torch.cuda.max_memory_allocated()
        if not (launches["K2"] > 0 and launches["K3"] > 0):
            fail(f"the {tag} run did not launch K2 and K3: {launches}")
        recs = sam_records(f"{d}/{tag}.sam")
        if len(recs) != N_READS:
            fail(f"{tag}: {len(recs)} SAM records for {N_READS} reads")
        frac_al, frac_ok = se_accuracy(recs, sim)
        qb = (f"q-gram build {build_ms['build'] / 1e3:.2f}s, "
              if tag == "qmap" else "")
        log(f"[mem_qmap] {tag} --device cuda --batch 4096: {N_READS} reads "
            f"in {stats['map_s']:.2f}s = {stats['reads_per_s']:.0f} reads/s "
            f"(load {stats['load_s']:.1f}s: {qb}not counted); peak "
            f"{peak / 2**30:.2f} GiB; aligned {frac_al:.4f}, correct "
            f"{frac_ok:.4f} of aligned; overflowed {stats['overflowed']}; "
            f"launches {launches}; K3 calls (NB, Lp, Lt, band_w, lanes with "
            f"a pattern) {calls['K3'][:3]}..., K2 calls "
            f"{sorted(set(c[:4] for c in calls['K2']))}")
        if frac_al < 0.95 or frac_ok < 0.90:
            fail(f"{tag} accuracy bars missed: aligned {frac_al}, correct "
                 f"{frac_ok}")
        same_sam(f"{d}/g.npz", ["-U", f"{d}/modes_sub.fq"],
                 f"{d}/{tag}_sub.sam", [], MODE_SUB, tag, tool=tool)
        rows[f"K3_{tag}"] = hold_call(torch, tag, "K3", kept["K3"])
        rows[f"K2_{tag}"] = hold_call(torch, tag, "K2", kept["K2"])
        out[tag] = {"launches": launches, "stats": stats, "aligned": frac_al,
                    "correct": frac_ok, "peak_bytes": peak,
                    "k3_calls": calls["K3"], "k2_calls": calls["K2"],
                    **({"qgram_build_s": build_ms["build"] / 1e3}
                       if tag == "qmap" else {})}
    torch.cuda.empty_cache()
    stages = mem_stage_breakdown(torch, np, f"{d}/g.npz", f"{d}/r.fq")
    log("[mem_qmap] one 4096-read mem_map batch, ms per stage (synchronised,"
        " median of 3): " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in stages.items()))
    secs = time.perf_counter() - t_phase
    log(f"[mem_qmap] phase {secs:.1f}s")
    return dict(out, rows=rows, stages_ms=stages, seconds=secs)


def phase_pe_local(torch, np):
    """--local on N_PE_LOCAL pairs of the paired-end run (its 5 % with
    mate 2's seeds broken included): the rescue is one window-wide band
    (band_w = maxins + 2 * 15 = 530), K4 on the card, every launch of it
    on the column sweep (wide_plan's tier)."""
    from nvbio_tpu_torch.models import paired as P
    from nvbio_tpu_torch.ops import long_dp

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "chr20len")
    for m in (1, 2):
        with open(f"{d}/pe{m}.fq") as src, open(f"{d}/pel{m}.fq", "w") as dst:
            for _ in range(4 * N_PE_LOCAL):
                dst.write(src.readline())
    launches, stats, calls, kept = mode_run(
        torch, f"{d}/g.npz", ["-1", f"{d}/pel1.fq", "-2", f"{d}/pel2.fq"],
        f"{d}/pel.sam", ["--local"], wraps=((P, "banded_score", "K4"),))
    sweeps = long_dp.launch.sweep_launches
    shapes = sorted({c[:4] for c in calls["K4"]})
    log(f"[pe_local] map_reads -1/-2 --local --device cuda --batch 4096: "
        f"{N_PE_LOCAL} pairs in {stats['map_s']:.2f}s = "
        f"{stats['pairs_per_s']:.0f} pairs/s; proper "
        f"{stats['proper_pairs'] / N_PE_LOCAL:.4f}, rescued "
        f"{stats['rescued']}, rescue_dropped {stats['rescue_dropped']}, "
        f"mates aligned {stats['aligned'] / (2 * N_PE_LOCAL):.4f}; launches "
        f"{launches}; the rescue's calls (NB, Lp, Lt, band_w): {shapes}")
    if not all(launches[k] > 0 for k in ("K2", "K3", "K4")):
        fail(f"the PE --local run did not launch K2, K3 and K4: {launches}")
    if (stats["rescued"] < 1 or stats["proper_pairs"] < 0.90 * N_PE_LOCAL
            or shapes != [(1024, LP, LP + 2 * 530, 530)]):
        fail(f"PE --local: rescued {stats['rescued']}, proper "
             f"{stats['proper_pairs']}, rescue calls {shapes}")
    # the rescue's window-wide calls take K4's column sweep, by the plan
    if (long_dp.wide_plan(LP, 530)[0] != long_dp.SWEEP
            or sweeps != launches["K4"]):
        fail(f"PE --local: {sweeps} of {launches['K4']} K4 launches on the "
             f"sweep (plan {long_dp.wide_plan(LP, 530)})")
    log(f"[pe_local] all {sweeps} K4 launches on the column sweep "
        f"(wide_plan {long_dp.wide_plan(LP, 530)})")
    same_sam(f"{d}/g.npz", ["-1", f"{d}/pe1_cpu.fq", "-2", f"{d}/pe2_cpu.fq"],
             f"{d}/pel_sub.sam", ["--local"], PE_CPU, "pe_local")
    rows = {"K4_local_rescue": hold_call(torch, "pe_local", "K4", kept["K4"])}
    secs = time.perf_counter() - t_phase
    log(f"[pe_local] phase {secs:.1f}s")
    return {"launches": launches, "sweep_launches": sweeps, "stats": stats,
            "rescue_calls": shapes, "rows": rows, "seconds": secs}


def head_fastq(src, dst, n, qual_shift=0):
    """The first ``n`` records of a FASTQ, each quality byte raised by
    ``qual_shift`` (31: Phred+33 -> Phred+64)."""
    with open(src) as f, open(dst, "w") as out:
        for i in range(4 * n):
            ln = f.readline()
            if qual_shift and i % 4 == 3:
                ln = "".join(chr(ord(c) + qual_shift)
                             for c in ln.rstrip("\n")) + "\n"
            out.write(ln)


def fastq_names(path):
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        return [ln[1:].rstrip("\n") for i, ln in enumerate(f) if i % 4 == 0]


def file_bytes(path):
    with (gzip.open if path.endswith(".gz") else open)(path, "rb") as f:
        return f.read()


#: the keys of the reference's MappingStats summary that do not time
STATS_KEYS = ("reads", "aligned", "aligned_pct", "unique", "proper_pairs",
              "discordant", "locate_dropped", "overflowed", "escalated",
              "mapq_hist")
HTML_SECTIONS = ("<h2>Summary</h2>", "<h2>MAPQ histogram (aligned reads)</h2>",
                 "<h2>Stage timing</h2>")


def phase_io_flags(torch, np):
    """map_reads' input and output options on the chr20-length index:
    --phred64 --un --al --rg-id --rg --stats --html on IO_SE reads (and
    their plain Phred+33 run), PE --un/--al/--rg-id on IO_PE pairs,
    --resume, --num-shards/--shard-id with sam_merge, CUDA = CPU on
    MODE_SUB reads, and an --xprof trace of one batch."""
    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.tools.map_reads import main as mapr
    from nvbio_tpu_torch.tools.sam_merge import main as merge

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "chr20len")
    npz = f"{d}/g.npz"
    head_fastq(f"{d}/r.fq", f"{d}/io.fq", IO_SE)
    head_fastq(f"{d}/r.fq", f"{d}/io64.fq", IO_SE, qual_shift=31)
    se_flags = ["--phred64", "--rg-id", "rg1", "--rg", "SM:s1", "--rg",
                "PL:ILLUMINA"]
    # the plain and the flagged run in turns (plain, flagged, flagged,
    # plain), so that the host clock's drift falls on both alike
    rates = {"plain": [], "flagged": []}
    for turn in ("plain", "flagged", "flagged", "plain"):
        if turn == "plain":
            _, plain, _, _ = mode_run(torch, npz, ["-U", f"{d}/io.fq"],
                                      f"{d}/io_plain.sam", [])
        else:
            launches, stats, _, kept = mode_run(
                torch, npz, ["-U", f"{d}/io64.fq"], f"{d}/io_flags.sam",
                se_flags + ["--html", f"{d}/io.html", "--un",
                            f"{d}/io_un.fq.gz", "--al", f"{d}/io_al.fq"],
                wraps=((M, "banded_score_packed", "K3"),
                       (M, "banded_directions", "K2")))
        rates[turn].append((plain if turn == "plain" else stats
                            )["reads_per_s"])
    if not (launches["K2"] > 0 and launches["K3"] > 0):
        fail(f"the flagged SE run did not launch K2 and K3: {launches}")
    recs = sam_records(f"{d}/io_flags.sam")
    header = [ln for ln in open(f"{d}/io_flags.sam") if ln.startswith("@")]
    if "@RG\tID:rg1\tSM:s1\tPL:ILLUMINA\n" not in header:
        fail(f"--rg-id/--rg: no @RG line in the header {header}")
    if not all(ln.endswith("\tRG:Z:rg1\n") for ln in recs):
        fail("--rg-id: a record lacks its trailing RG:Z:rg1 tag")
    plain_recs = sam_records(f"{d}/io_plain.sam")
    if [ln[:-len("\tRG:Z:rg1\n")] + "\n" for ln in recs] != plain_recs:
        fail("--phred64 --rg-id: the records with RG:Z stripped differ "
             "from the plain Phred+33 run's")
    mapped = [ln.split("\t", 1)[0] for ln in recs
              if not int(ln.split("\t", 2)[1]) & 4]
    unmapped = [ln.split("\t", 1)[0] for ln in recs
                if int(ln.split("\t", 2)[1]) & 4]
    if (fastq_names(f"{d}/io_al.fq") != mapped
            or fastq_names(f"{d}/io_un.fq.gz") != unmapped):
        fail("--un/--al: the routed reads are not the unmapped/mapped SAM "
             "records")
    if (stats["reads"] != IO_SE or stats["aligned"] != len(mapped)
            or sum(stats["mapq_hist"].values()) != stats["aligned"]
            or not set(STATS_KEYS) | {"reads_per_s", "reads_per_sec",
                                      "stage_seconds"} <= set(stats)):
        fail(f"--stats: {stats} against {IO_SE} reads, {len(mapped)} mapped")
    html = open(f"{d}/io.html").read()
    if not all(h in html for h in HTML_SECTIONS):
        fail("--html: the report lacks one of its three sections")
    log(f"[io_flags] map_reads --device cuda --batch 4096 on {IO_SE} reads, "
        f"in turns: plain Phred+33 "
        f"{', '.join(f'{r:.0f}' for r in rates['plain'])} reads/s; with "
        f"{' '.join(se_flags)} --un --al --stats --html "
        f"{', '.join(f'{r:.0f}' for r in rates['flagged'])} reads/s (last "
        f"run: "
        f"reads_per_sec over the total timer "
        f"{stats['reads_per_sec']:.0f}, stage seconds "
        f"{stats['stage_seconds']}); records equal with RG:Z stripped, "
        f"--un {len(unmapped)} / --al {len(mapped)} reads as the SAM's, "
        f"stats and HTML checked; launches {launches}")
    rows = {"K3_io": hold_call(torch, "io_flags", "K3", kept["K3"])}

    # paired-end: both mates routed, /1 and /2 under mate 1's names
    head_fastq(f"{d}/pe1.fq", f"{d}/io_pe1.fq", IO_PE)
    head_fastq(f"{d}/pe2.fq", f"{d}/io_pe2.fq", IO_PE)
    pe_launches, pe_stats, _, _ = mode_run(
        torch, npz, ["-1", f"{d}/io_pe1.fq", "-2", f"{d}/io_pe2.fq"],
        f"{d}/io_pe.sam", ["--un", f"{d}/io_pe_un.fq", "--al",
                           f"{d}/io_pe_al.fq", "--rg-id", "rg1"])
    pe_recs = sam_records(f"{d}/io_pe.sam")
    routed = {(o, m): sum(n.endswith(f"/{m}") for n in fastq_names(
        f"{d}/io_pe_{o}.fq")) for o in ("un", "al") for m in (1, 2)}
    want = {("al", m): sum(not int(ln.split("\t", 2)[1]) & 4
                           for ln in pe_recs[m - 1::2]) for m in (1, 2)}
    want.update({("un", m): IO_PE - want["al", m] for m in (1, 2)})
    log(f"[io_flags] PE --un --al --rg-id, {IO_PE} pairs: "
        f"{pe_stats['pairs_per_s']:.0f} pairs/s, routed (outcome, mate) "
        f"{routed}, rescued {pe_stats['rescued']}; launches {pe_launches}")
    if routed != want or pe_launches["K4"] < 1 or not all(
            ln.endswith("\tRG:Z:rg1\n") for ln in pe_recs):
        fail(f"PE --un/--al: routed {routed} against the SAM's {want}, "
             f"launches {pe_launches}")

    # --resume: a run cut after 3 batches, resumed over all the reads
    head_fastq(f"{d}/r.fq", f"{d}/io_cut.fq", IO_CUT)
    for fq, extra in ((f"{d}/io_cut.fq", []), (f"{d}/io.fq", ["--resume"])):
        mapr(["-x", npz, "-U", fq, "-S", f"{d}/io_resume.sam", "--device",
              DEV, "--batch", "4096", *extra])
    if sam_records(f"{d}/io_resume.sam") != plain_recs:
        fail("--resume: the resumed records differ from the uninterrupted "
             "run's")

    # --num-shards/--shard-id, then sam_merge: the single run's lines
    shards = [f"{d}/io_shard{k}.sam" for k in range(2)]
    for k, sp in enumerate(shards):
        mapr(["-x", npz, "-U", f"{d}/io.fq", "-S", sp, "--device", DEV,
              "--batch", "4096", "--num-shards", "2", "--shard-id", str(k)])
    merge(shards + ["-o", f"{d}/io_merged.sam"])
    no_pg = lambda p: [ln for ln in open(p) if not ln.startswith("@PG")]
    if no_pg(f"{d}/io_merged.sam") != no_pg(f"{d}/io_plain.sam"):
        fail("--num-shards 2 + sam_merge: the merged SAM differs from the "
             "single run's")
    log(f"[io_flags] --resume after {IO_CUT} reads and --num-shards 2 + "
        f"sam_merge ({len(sam_records(shards[0]))} + "
        f"{len(sam_records(shards[1]))} records): the single run's records")

    # the SE flag set under both devices: SAM, --un/--al and stats equal
    head_fastq(f"{d}/io64.fq", f"{d}/io64_sub.fq", MODE_SUB)
    out, secs = {}, {}
    for dev in (DEV, "cpu"):
        p = f"{d}/io_{dev}"
        t0 = time.perf_counter()
        mapr(["-x", npz, "-U", f"{d}/io64_sub.fq", "-S", f"{p}.sam",
              "--device", dev, "--batch", str(MODE_SUB), *se_flags,
              "--html", f"{p}.html", "--un", f"{p}_un.fq.gz", "--al",
              f"{p}_al.fq", "--stats", f"{p}.json"])
        secs[dev] = time.perf_counter() - t0
        st = json.load(open(f"{p}.json"))
        out[dev] = ([ln for ln in open(f"{p}.sam") if not
                     ln.startswith("@PG")], file_bytes(f"{p}_un.fq.gz"),
                    file_bytes(f"{p}_al.fq"), {k: st[k] for k in STATS_KEYS})
    for i, what in enumerate(("SAM", "--un", "--al", "stats")):
        if out[DEV][i] != out["cpu"][i]:
            fail(f"io_flags: --device cpu {what} differs from --device cuda")
    log(f"[io_flags] {MODE_SUB} reads at --batch {MODE_SUB} with the SE flag"
        f" set: identical SAM, --un/--al bytes and stats under --device "
        f"cuda ({secs[DEV]:.1f}s) and --device cpu ({secs['cpu']:.1f}s)")

    # --xprof: a torch.profiler trace of one batch
    head_fastq(f"{d}/r.fq", f"{d}/io_4k.fq", 4096)
    t0 = time.perf_counter()
    mapr(["-x", npz, "-U", f"{d}/io_4k.fq", "-S", f"{d}/io_prof.sam",
          "--device", DEV, "--batch", "4096", "--xprof", f"{d}/xprof"])
    prof_s = time.perf_counter() - t0
    trace_path = f"{d}/xprof/map_reads.trace.json"
    trace = json.load(open(trace_path))
    kernels = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    # K2 and K3 are group_gotoh_kernel instantiations, launched through
    # ctypes from the library the build phase made
    hand = {k: v for k, v in kernels.items() if "group_gotoh_kernel" in k}
    log(f"[io_flags] --xprof on one 4096-read batch ({prof_s:.1f}s, trace "
        f"{os.path.getsize(trace_path) / 2**20:.1f} MiB): "
        f"{sum(kernels.values())} kernel events of {len(kernels)} kernels; "
        f"the hand kernels K2 and K3 (group_gotoh_kernel): "
        + (f"{sum(hand.values())} events of {len(hand)} instantiations"
           if hand else "not in the trace"))
    if not kernels:
        fail("--xprof: the trace holds no kernel event")
    secs_phase = time.perf_counter() - t_phase
    log(f"[io_flags] phase {secs_phase:.1f}s")
    return {"launches": launches, "stats": stats, "plain_stats": plain,
            "reads_per_s_turns": rates,
            "pe_launches": pe_launches, "pe_stats": pe_stats,
            "pe_routed": {f"{o}/{m}": v for (o, m), v in routed.items()},
            "cpu_subset_s": secs["cpu"], "xprof_kernel_events":
            sum(kernels.values()), "xprof_hand_kernels": hand,
            "xprof_s": prof_s, "rows": rows, "seconds": secs_phase}


def se_fields(rec):
    """(aligned, RNAME, POS, strand, CIGAR, AS, MD, NM) of a SAM record:
    the fields a sharded run must share with the unsharded one."""
    f = rec.rstrip("\n").split("\t")
    flag = int(f[1])
    if flag & 4:
        return (False,)
    tags = {t[:2]: t[5:] for t in f[11:]}
    return (True, f[2], int(f[3]), flag & 16, f[5], tags["AS"], tags["MD"],
            tags["NM"])


def pair_score(recs):
    """Summed AS of a pair's aligned mates (None with a mate unaligned)."""
    out = 0
    for rec in recs:
        f = rec.split("\t")
        if int(f[1]) & 4:
            return None
        out += int({t[:2]: t[5:] for t in f[11:]}["AS"])
    return out


def device_bytes(torch, make):
    """Device bytes held by what ``make()`` returns, freed after."""
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    held = make()
    torch.cuda.synchronize()
    nbytes = torch.cuda.memory_allocated() - m0
    del held
    torch.cuda.empty_cache()
    return nbytes


def sharded_stage_breakdown(torch, np, m, reads_fq):
    """Host-clock ms per stage (synchronised) of a ShardedMapper ``m``'s
    full batches through map_stream and to_sam_records, as the CLI runs
    them; the median of batches 2-4.  Wrappers time the upload, the
    strands and seeds, each shard's candidate stage, the cross-shard
    top-2 and the winner-shard traceback (escalation rounds included);
    the host finish is what is left of the batch."""
    import itertools

    from nvbio_tpu_torch.io.sequence import ReadBatchIterator
    from nvbio_tpu_torch.models import sharded_mapper as SM
    from nvbio_tpu_torch.strings.string_set import pack_reads

    batches = []
    for names, seqs, quals in itertools.islice(
            ReadBatchIterator(reads_fq, m.params.batch_size), 4):
        reads, lens, qmat, _ = pack_reads(seqs, quals)
        batches.append((names, reads, lens, qmat))
    t = {}
    timed = stage_timer(torch, t)

    def shard_of(a):
        return "candidate stage, shard " + str(
            [st is a[0] for st in m.shard_state].index(True))

    wrap = {"stage_reads": timed("strands+seeds", SM.stage_reads),
            "_shard_cands": timed(shard_of, SM._shard_cands),
            "_sharded_top2": timed("top2 across shards", SM._sharded_top2),
            "_sharded_walk": timed("traceback (K2)+walk", SM._sharded_walk)}
    saved = {name: getattr(SM, name) for name in wrap}
    m._upload = timed("upload", m._upload)
    rows = []
    try:
        for name, fn in wrap.items():
            setattr(SM, name, fn)
        stream = m.map_stream(iter(batches))
        for _ in batches:
            t.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            names, seqs, lens, quals, results = next(stream)
            recs = m.to_sam_records(names, seqs, lens, quals, results)
            total = (time.perf_counter() - t0) * 1e3
            assert len(recs) == len(names)
            rows.append(dict(t, **{
                "host finish+SAM records": total - sum(t.values()),
                "batch": total}))
    finally:
        for name, fn in saved.items():
            setattr(SM, name, fn)
        del m._upload
    rows = rows[1:] or rows  # the first batch warms the allocator
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def phase_sharded(torch, np):
    """The sharded index on the chr20-length genome: build_index
    --shard-bp 16777216 --shard-overlap 1024 --procs 4 (4 shards); the
    short-read run's 100 000 reads and the paired-end run's first 4
    batches of pairs through map_reads on the manifest, each with the
    counts reset just before; every read equal to the unsharded run in
    (aligned, POS, strand, CIGAR, AS, MD, NM), every differing pair the
    documented anchor divergence (proper, its score no lower); CUDA SAM =
    CPU SAM on 1 024 reads and 256 pairs; K3, K2 and K4 held against
    their plain versions on sharded calls; the device bytes of the loaded
    mappers."""
    from nvbio_tpu_torch.fmindex.sharded import load_sharded_index
    from nvbio_tpu_torch.io.index_file import load_index
    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.models import paired as P
    from nvbio_tpu_torch.models.params import MapperParams
    from nvbio_tpu_torch.models.sharded_mapper import ShardedMapper

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "chr20len")
    idx = f"{d}/sh.manifest.json"
    build_s, spans = build_shards(d)
    params = MapperParams(sa_sample=4, lut_k=11)

    def unsharded():
        fm, ssa, g, meta = load_index(f"{d}/g.npz", device=DEV)
        return M.Mapper(fm, ssa, g, params=params, lut=meta.get("lut"))

    held = device_bytes(torch, lambda: ShardedMapper(
        *load_sharded_index(f"{d}/sh", device=DEV)[:2], params=params))
    held_1 = device_bytes(torch, unsharded)
    log(f"[sharded] build_index --shard-bp {SHARD_BP} --shard-overlap "
        f"{SHARD_OVERLAP} --procs {SHARD_PROCS}: {len(spans)} shards "
        f"(start, length) {spans} in {build_s:.1f}s; the loaded mapper "
        f"holds {held / 2**20:.1f} MiB on the card (unsharded "
        f"{held_1 / 2**20:.1f} MiB)")

    launches, stats, calls, kept = mode_run(
        torch, idx, ["-U", f"{d}/r.fq"], f"{d}/sh.sam", MESH_OFF,
        wraps=((M, "banded_score_packed", "K3"),
               (M, "banded_directions", "K2")))
    recs, base = sam_records(f"{d}/sh.sam"), sam_records(f"{d}/gpu.sam")
    if len(recs) != N_READS:
        fail(f"sharded: {len(recs)} SAM records for {N_READS} reads")
    n_diff = sum(se_fields(a) != se_fields(b) for a, b in zip(recs, base))
    n_line = sum(a != b for a, b in zip(recs, base))
    log(f"[sharded] map_reads -x sh.manifest.json --device cuda --batch "
        f"4096: {N_READS} reads in {stats['map_s']:.2f}s = "
        f"{stats['reads_per_s']:.0f} reads/s; {n_diff} reads differ from "
        f"the unsharded run in (aligned, POS, strand, CIGAR, AS, MD, NM) "
        f"({n_line} whole records); escalated {stats['escalated']}, "
        f"locate_dropped {stats['locate_dropped']}; launches {launches}; K3 "
        f"calls (NB, Lp, Lt, band_w, lanes with a pattern) {calls['K3'][:4]}"
        f"..., K2 calls {sorted(set(c[:4] for c in calls['K2']))}")
    if n_diff:
        fail(f"sharded: {n_diff} reads differ from the unsharded run")
    if not (launches["K2"] > 0 and launches["K3"] == 4 * launches["K2"]):
        fail(f"the sharded run did not launch K3 once a shard and batch "
             f"and K2 once a batch: {launches}")

    for m in (1, 2):
        head_fastq(f"{d}/pe{m}.fq", f"{d}/shpe{m}.fq", N_SHARD_PAIRS)
    pairs = ["-1", f"{d}/shpe1.fq", "-2", f"{d}/shpe2.fq"]

    def unsharded_pairs_per_s():
        return mode_run(torch, f"{d}/g.npz", pairs, f"{d}/unshpe.sam",
                        [])[1]["pairs_per_s"]

    # the unsharded index on the same pairs before and after: the ratio
    unsharded_pe = [unsharded_pairs_per_s()]
    pe_launches, pe_stats, pe_calls, pe_kept = mode_run(
        torch, idx, pairs, f"{d}/shpe.sam", MESH_OFF,
        wraps=((P, "banded_score", "K4"),))
    unsharded_pe.append(unsharded_pairs_per_s())
    got = sam_records(f"{d}/shpe.sam")
    base = sam_records(f"{d}/pe.sam")[:2 * N_SHARD_PAIRS]
    if len(got) != 2 * N_SHARD_PAIRS:
        fail(f"sharded PE: {len(got)} SAM records for {N_SHARD_PAIRS} pairs")
    differ = [i for i in range(N_SHARD_PAIRS)
              if got[2 * i:2 * i + 2] != base[2 * i:2 * i + 2]]
    for i in differ:
        a, b = got[2 * i:2 * i + 2], base[2 * i:2 * i + 2]
        sa, sb = pair_score(a), pair_score(b)
        if not (all(int(r.split("\t")[1]) & 2 for r in a)
                and (sb is None or sa >= sb)):
            fail(f"sharded PE: pair {i} differs from the unsharded run "
                 f"otherwise than by a better rescue anchor:\n{a}\n{b}")
    log(f"[sharded] map_reads -1/-2 on the manifest, --device cuda --batch "
        f"4096: {N_SHARD_PAIRS} pairs in {pe_stats['map_s']:.2f}s = "
        f"{pe_stats['pairs_per_s']:.0f} pairs/s (unsharded on the same "
        f"pairs before and after: {unsharded_pe[0]:.0f}, "
        f"{unsharded_pe[1]:.0f}); proper "
        f"{pe_stats['proper_pairs'] / N_SHARD_PAIRS:.4f}, rescued "
        f"{pe_stats['rescued']}, rescue_dropped "
        f"{pe_stats['rescue_dropped']}; {len(differ)} pairs differ from the "
        f"unsharded run, each proper with its score no lower (the anchor "
        f"divergence); launches {pe_launches}; the rescue's calls "
        f"{sorted({c[:4] for c in pe_calls['K4']})}")
    if not all(pe_launches[k] > 0 for k in ("K2", "K3", "K4")):
        fail(f"the sharded PE run did not launch K2, K3 and K4: "
             f"{pe_launches}")

    stages = sharded_stage_breakdown(torch, np, ShardedMapper(
        *load_sharded_index(f"{d}/sh", device=DEV)[:2],
        params=MapperParams(seed_interval_fn="S", seed_interval_a=1.0,
                            seed_interval_b=1.15, batch_size=4096,
                            sa_sample=4, lut_k=11)), f"{d}/r.fq")
    log("[sharded] one 4096-read batch, ms per stage (synchronised, median "
        "of 3): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))

    head_fastq(f"{d}/r.fq", f"{d}/sh_sub.fq", SHARD_CPU_READS)
    for m in (1, 2):
        head_fastq(f"{d}/pe{m}.fq", f"{d}/shpe{m}_sub.fq", SHARD_CPU_PAIRS)
    _, se_secs = same_sam(idx, ["-U", f"{d}/sh_sub.fq"], f"{d}/sh_sub.sam",
                          MESH_OFF, SHARD_CPU_READS, "sharded")
    _, pe_secs = same_sam(idx, ["-1", f"{d}/shpe1_sub.fq", "-2",
                                f"{d}/shpe2_sub.fq"], f"{d}/shpe_sub.sam",
                          MESH_OFF, SHARD_CPU_PAIRS, "sharded_pe")
    rows = {"K3_sharded": hold_call(torch, "sharded", "K3", kept["K3"]),
            "K2_sharded": hold_call(torch, "sharded", "K2", kept["K2"]),
            "K4_sharded_rescue": hold_call(torch, "sharded_pe", "K4",
                                           pe_kept["K4"])}
    secs = time.perf_counter() - t_phase
    log(f"[sharded] phase {secs:.1f}s")
    return {"build_s": build_s, "shards": spans, "held_bytes": held,
            "unsharded_held_bytes": held_1, "launches": launches,
            "stats": stats, "n_diff": n_diff, "n_line_diff": n_line,
            "k3_calls": calls["K3"], "pe_launches": pe_launches,
            "pe_stats": pe_stats, "pe_differ": differ,
            "unsharded_pairs_per_s": unsharded_pe,
            "rescue_calls": sorted({c[:4] for c in pe_calls["K4"]}),
            "cuda_cpu_s": {"se": se_secs, "pe": pe_secs}, "rows": rows,
            "stages_ms": stages,
            "seconds": secs}


def phase_self_test(torch):
    """self_test --device cuda at full size (1 Mbp, 2 000 reads): all five
    checks ok, K1 against its plain version among them, and the native
    CIGAR/MD builder (not the Python fallback) finishing every batch."""
    import contextlib
    import io
    import re

    from nvbio_tpu_torch.models import mapper as M
    from nvbio_tpu_torch.tools.self_test import main as self_test

    native = []
    real = M.ops_batch_native

    def counted(*a, **kw):
        out = real(*a, **kw)
        native.append(out is not None)
        return out

    err = io.StringIO()
    M.ops_batch_native = counted
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = self_test(["--device", DEV])
    finally:
        M.ops_batch_native = real
    secs = time.perf_counter() - t0
    log(err.getvalue().rstrip())
    checks = [(c.strip(), v) for c, v in re.findall(
        r"^\[self_test\] (.{34}) (ok|FAIL)  ", err.getvalue(), re.M)]
    log(f"[self_test] self_test --device {DEV}: exit {rc} in {secs:.2f}s; "
        f"checks {checks}; the native builder finished {sum(native)} of "
        f"{len(native)} batches")
    want = ["SE alignment rate", "SE true-locus accuracy", "PE proper pairs",
            "banded Gotoh vs oracle", "K1 == its plain version",
            "device sufsort vs SA-IS"]
    if rc != 0 or checks != [(c, "ok") for c in want]:
        fail(f"self_test --device {DEV}: exit {rc}, checks {checks}")
    if not native or not all(native):
        fail(f"self_test: ops_batch_native returned None on "
             f"{native.count(False)} of {len(native)} batches (the Python "
             "fallback ran on the card)")
    return {"seconds": secs, "checks": checks, "native_batches": len(native)}


def phase_fm_server(torch, np):
    """fm_server serve on the chr20-length g.npz in a thread on the card:
    one SE request of the short-read run's first SRV_SE reads and one PE
    request of the paired-end run's first SRV_PAIRS pairs, each twice
    (cold, then warm); each SAM equal to map_reads' on the same input at
    the server's settings (-i 11, --batch 4096), @PG masked; attach
    seconds, reads/s and pairs/s of each request."""
    import tempfile
    import threading

    from nvbio_tpu_torch.tools import fm_server
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    d = os.path.join(WORK, "chr20len")
    head_fastq(f"{d}/r.fq", f"{d}/srv.fq", SRV_SE)
    for m in (1, 2):
        head_fastq(f"{d}/pe{m}.fq", f"{d}/srvpe{m}.fq", SRV_PAIRS)
    sock_dir = tempfile.mkdtemp(prefix="fms")  # AF_UNIX paths: < 108 bytes
    sock = os.path.join(sock_dir, "fm.sock")
    t = threading.Thread(target=fm_server.serve, args=(f"{d}/g.npz", sock),
                         kwargs=dict(batch=4096, device=DEV), daemon=True)
    t0 = time.perf_counter()
    t.start()
    while not os.path.exists(sock):
        if not t.is_alive():
            fail("fm_server stopped before serving")
        time.sleep(0.05)
    up_s = time.perf_counter() - t0
    out = {"socket_up_s": up_s, "requests": []}
    try:
        for tag, req, n in (
                ("se", {"u": f"{d}/srv.fq"}, SRV_SE),
                ("pe", {"m1": f"{d}/srvpe1.fq", "m2": f"{d}/srvpe2.fq"},
                 SRV_PAIRS)):
            for turn in ("cold", "warm"):
                t0 = time.perf_counter()
                r = fm_server.request(sock, {"cmd": "map", **req,
                                             "sam": f"{d}/srv_{tag}.sam"})
                secs = time.perf_counter() - t0
                if r["status"] != "ok":
                    fail(f"fm_server {tag} request: {r}")
                row = {"kind": tag, "turn": turn, "seconds": secs,
                       "server_seconds": r["seconds"], "per_s": n / secs,
                       "attach_seconds": r["attach_seconds"],
                       "aligned": r["aligned"], "reads": r["reads"]}
                out["requests"].append(row)
                log(f"[fm_server] {turn} {tag} request: {n} "
                    f"{'reads' if tag == 'se' else 'pairs'} in {secs:.3f}s "
                    f"(the server's own {r['seconds']}s) = {n / secs:.0f} "
                    f"{'reads' if tag == 'se' else 'pairs'}/s; aligned "
                    f"{r['aligned']} of {r['reads']} reads; attach "
                    f"{r['attach_seconds']}s")
            inputs = (["-U", req["u"]] if tag == "se"
                      else ["-1", req["m1"], "-2", req["m2"]])
            mapr(["-x", f"{d}/g.npz", *inputs, "-S", f"{d}/srv_cli_{tag}.sam",
                  "--device", DEV, "--batch", "4096", "-i", SRV_INTERVAL])
            got = sam_records(f"{d}/srv_{tag}.sam")
            want = sam_records(f"{d}/srv_cli_{tag}.sam")
            if got != want:
                n_diff = sum(a != b for a, b in zip(got, want))
                fail(f"fm_server {tag}: {n_diff} of {len(want)} records "
                     "differ from map_reads'")
            log(f"[fm_server] {tag}: the server's SAM records = map_reads' "
                f"({len(got)} records)")
    finally:
        try:
            fm_server.request(sock, {"cmd": "stop"}, timeout=60)
        finally:
            t.join(timeout=120)
            shutil.rmtree(sock_dir, ignore_errors=True)
    if t.is_alive():
        fail("fm_server did not stop")
    out["attach_seconds"] = out["requests"][0]["attach_seconds"]
    return out


def _mesh_batches(np, paths, n):
    """The first ``n`` reads (pairs, with two paths) of FASTQ ``paths``
    packed in batches of 4096, as map_reads packs them."""
    from nvbio_tpu_torch.io.fastq import FastqBatchReader
    from nvbio_tpu_torch.strings.string_set import pack_reads

    its = [FastqBatchReader(p, 4096) for p in paths]
    out, got = [], 0
    for mates in zip(*its):
        packed = []
        for _, seqs, quals in mates:
            reads, lens, qmat, _ = pack_reads(seqs, quals)
            packed += [reads, lens, qmat]
        out.append(packed)
        got += len(mates[0][1])
        if got >= n:
            break
    return out


def phase_mesh(torch, np):
    """The shard-per-device mesh on the sharded phase's 4-shard manifest:
    MeshShardedMapper and MeshPairedShardedMapper with shard k on
    cuda:(k mod device_count), beside the sequential ShardedMapper in the
    same process: MESH_SE reads, MESH_PAIRS pairs and -a --max-alns
    MESH_ALNS on MESH_ALL reads, each run after a warm-up batch of each
    mapper in turns (sequential, mesh, mesh, sequential), every result
    equal (MapResult fields, pair info), the launch counts, reads/s and
    pairs/s of both schedules, the device count and each shard's device
    and bytes;
    with fewer cards than shards, map_reads --mesh on stops with the
    reference's message."""
    from dataclasses import asdict

    from nvbio_tpu_torch.fmindex.sharded import load_sharded_index
    from nvbio_tpu_torch.models.mesh_sharded import (
        MeshPairedShardedMapper, MeshShardedMapper)
    from nvbio_tpu_torch.models.params import MapperParams
    from nvbio_tpu_torch.models.sharded_mapper import (PairedShardedMapper,
                                                       ShardedMapper)
    from nvbio_tpu_torch.ops import banded_dp

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "chr20len")
    sidx, genome, _ = load_sharded_index(f"{d}/sh", device="cpu")
    seq_idx = load_sharded_index(f"{d}/sh", device=DEV)[0]
    S = len(sidx.shards)
    n_dev = torch.cuda.device_count()
    devices = ([torch.device(DEV)] * S if DEV == "cpu"
               else [torch.device("cuda", k % n_dev) for k in range(S)])
    # map_reads' settings: --batch 4096, --max-read-len 320
    params = MapperParams(sa_sample=4, lut_k=11, batch_size=4096,
                          max_read_len=320)
    mesh = MeshShardedMapper(sidx, genome, params=params, devices=devices)
    seq = ShardedMapper(seq_idx, genome, params=params)
    budget = mesh.hbm_budget()
    log(f"[mesh] {n_dev} card(s); shard k on {[str(x) for x in devices]}, "
        f"resident bytes by shard {mesh._resident}; by device "
        + "; ".join(f"{k}: shards {b['shards']}, resident "
                    f"{b['resident_index'] / 2**20:.1f} MiB, transient "
                    f"{b['transient_batch'] / 2**20:.1f} MiB, limit "
                    f"{(b['limit'] or 0) / 2**30:.1f} GiB"
                    for k, b in budget.items()))
    se = _mesh_batches(np, [f"{d}/r.fq"], MESH_SE)
    pe = _mesh_batches(np, [f"{d}/shpe1.fq", f"{d}/shpe2.fq"], MESH_PAIRS)

    def sync():
        for k in range(n_dev):
            torch.cuda.synchronize(k)

    def turns(pair, fn, batches, what):
        """``fn(mapper, *batch)`` over ``batches`` with the sequential and
        the mesh mapper of ``pair``: one untimed batch each (the first
        launches of each kernel on each card load it there), then
        sequential, mesh, mesh, sequential; every timed result equal, or
        fail.  Returns (seconds by schedule, launches of its last run by
        schedule)."""
        for m in pair.values():
            fn(m, *batches[0])
        secs, res, launches = {"sequential": [], "mesh": []}, {}, {}
        for tag in ("sequential", "mesh", "mesh", "sequential"):
            banded_dp.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            got = [fn(pair[tag], *b) for b in batches]
            sync()
            secs[tag].append(time.perf_counter() - t0)
            if got != res.setdefault(tag, got):
                fail(f"mesh {what}: two {tag} runs differ")
            launches[tag] = {k: f.launches for k, f in
                             banded_dp.KERNELS.items() if f.launches}
        if res["mesh"] != res["sequential"]:
            fail(f"mesh {what}: results differ from the sequential mapper's")
        return secs, launches

    def se_fn(m, reads, lens, qmat):
        return [asdict(r) for r in m.map_reads(reads, lens, qmat)]

    def pe_fn(m, *b):
        r1, r2, info = m.map_pairs(*b)
        return ([asdict(r) for r in r1], [asdict(r) for r in r2], info)

    def all_fn(m, reads, lens, qmat):
        return [[asdict(a) for a in xs] for xs in m.map_reads_all(
            reads[:MESH_ALL], lens[:MESH_ALL], qmat[:MESH_ALL],
            max_alns=MESH_ALNS)]

    out = {"devices": [str(x) for x in devices], "device_count": n_dev,
           "resident_bytes": mesh._resident, "budget": budget}
    secs, out["se_launches"] = turns({"sequential": seq, "mesh": mesh},
                                     se_fn, se, "SE")
    n_reads = sum(len(b[1]) for b in se)
    out["se_reads_per_s"] = {k: [n_reads / v for v in vs]
                             for k, vs in secs.items()}
    log(f"[mesh] SE, {n_reads} reads, after a warm-up batch each, "
        f"sequential / mesh / mesh / sequential: every MapResult equal; "
        f"reads/s {out['se_reads_per_s']}; launches {out['se_launches']}")

    pmesh = MeshPairedShardedMapper(sidx, genome, params=params,
                                    devices=devices)
    pseq = PairedShardedMapper(seq_idx, genome, params=params)
    n_pairs = sum(len(b[1]) for b in pe)
    secs, out["pe_launches"] = turns({"sequential": pseq, "mesh": pmesh},
                                     pe_fn, pe, "PE")
    out["pe_pairs_per_s"] = {k: [n_pairs / v for v in vs]
                             for k, vs in secs.items()}
    out["pe_rescued"] = {"mesh": pmesh.rescued, "sequential": pseq.rescued}
    log(f"[mesh] PE, {n_pairs} pairs, after a warm-up batch each: every "
        f"pair equal; pairs/s {out['pe_pairs_per_s']}; rescued (3 runs) "
        f"{out['pe_rescued']}; launches {out['pe_launches']}")

    out["all_seconds"], out["all_launches"] = turns(
        {"sequential": seq, "mesh": mesh}, all_fn, se[:1], "-a")
    log(f"[mesh] -a --max-alns {MESH_ALNS}, {MESH_ALL} reads: every list "
        f"equal; seconds {out['all_seconds']}; launches "
        f"{out['all_launches']}")
    del mesh, seq, pmesh, pseq, seq_idx

    if DEV != "cpu" and n_dev < S:
        from nvbio_tpu_torch.tools.map_reads import main as mapr

        want_msg = (f"need >= {S} devices for {S} shards, have {n_dev} (use "
                    "the sequential ShardedMapper)")
        try:
            mapr(["-x", f"{d}/sh.manifest.json", "-U", f"{d}/sh_sub.fq",
                  "-S", f"{d}/mesh_on.sam", "--device", DEV, "--mesh", "on"])
        except ValueError as e:
            if str(e) != want_msg:
                fail(f"map_reads --mesh on with {n_dev} card(s): {e}")
        else:
            fail(f"map_reads --mesh on mapped {S} shards on {n_dev} card(s)")
        log(f"[mesh] map_reads --mesh on with {n_dev} card(s) for {S} shards "
            f"stops: {want_msg}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase {out['seconds']:.1f}s")
    return out


def write_proteins(path, names, seqs):
    from nvbio_tpu_torch.basic.alphabet import decode_protein

    with open(path, "w") as f:
        for name, s in zip(names, seqs):
            f.write(f">{name}\n{decode_protein(s)}\n")


def read_tsv_scores(np, path, nq, nt):
    with open(path) as f:
        rows = f.read().splitlines()[1:]
    if len(rows) != nq * nt:
        fail(f"{path}: {len(rows)} score rows for {nq} x {nt} alignments")
    return np.array([int(r.rsplit("\t", 1)[1]) for r in rows]).reshape(nq, nt)


def protein_inputs(np):
    """protein_sw's seeded proteins: PROT_Q queries and PROT_T targets of
    PROT_MIN-PROT_MAX residues, half the queries planted as ~30 %
    substituted copies inside targets.  Returns (queries, targets,
    {query: its target})."""
    rng = np.random.default_rng(SEED + 70)
    Q, T = PROT_Q, PROT_T
    qlens = rng.integers(PROT_MIN, PROT_MAX + 1, Q)
    tlens = rng.integers(PROT_MIN, PROT_MAX + 1, T)
    qs = [rng.integers(0, 20, n).astype(np.uint8) for n in qlens]
    ts = [rng.integers(0, 20, n).astype(np.uint8) for n in tlens]
    planted = dict(zip(range(0, Q, 2), rng.choice(T, Q // 2, replace=False)))
    for i, j in planted.items():
        seg = qs[i].copy()
        sub = rng.random(len(seg)) < 0.3
        seg[sub] = rng.integers(0, 20, int(sub.sum()))
        if len(ts[j]) <= len(seg):
            ts[j] = seg
        else:
            s = int(rng.integers(0, len(ts[j]) - len(seg) + 1))
            ts[j][s:s + len(seg)] = seg
    return qs, ts, planted


def protein_batch(torch, np, qs, ts):
    """protein_sw's all-pairs batch on the card, laid out as the CLI lays
    it out (query i against target j at row i * T + j), its band
    (max(Lq, Lt): full_score_batch's), and the strided PROT_HOLD-pair
    subset K5_matrix is held and timed on."""
    from nvbio_tpu_torch.basic.alphabet import PROTEIN_X

    dev = torch.device(DEV)

    def pack(seqs):
        m = np.full((len(seqs), max(map(len, seqs))), PROTEIN_X, np.int8)
        for i, s in enumerate(seqs):
            m[i, :len(s)] = s
        return (torch.from_numpy(m).to(dev), torch.from_numpy(
            np.array([len(s) for s in seqs], np.int32)).to(dev))

    Q, T = len(qs), len(ts)
    (pt, pl), (tt, tl) = pack(qs), pack(ts)
    full = (pt.repeat_interleave(T, dim=0), pl.repeat_interleave(T),
            tt.repeat(Q, 1), tl.repeat(Q))
    idx = torch.arange(0, Q * T, max(Q * T // PROT_HOLD, 1), device=dev)
    return full, tuple(a[idx] for a in full), max(pt.shape[1], tt.shape[1])


def k5_full_ptxas(text, kernel="k5_full_kernel"):
    """Registers, shared bytes and spills of each instantiation of the
    full-band tier's kernel (k5_full_kernel), or of ``kernel``
    (k5_band_kernel: with its ``max_warps``), from nvcc's ptxas report of
    wavefront_gotoh.cu."""
    import re

    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            g = re.search(kernel + r"ILi(\d)E(?:Li(\d+)E)?", m.group(1))
            cur = {"atype": int(g[1])} if g else None
            if cur:
                if g[2]:
                    cur["max_warps"] = int(g[2])
                out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m[1]) if m else 0
    return out


def k5_full_occupancy(torch, nb, lp, band_w):
    """Warps an SM the full-band tier keeps resident (LOCAL: the
    runtime's occupancy over its registers and shared bytes), those a
    call over ``nb`` alignments fills (a warp an alignment) and its
    scratch bytes at this shape; None for a package without the tier
    (the parent of a --turns run)."""
    from nvbio_tpu_torch.ops import _build, wavefront_dp

    lib = _build.library()
    if not hasattr(lib, "k5_full_warps_per_sm"):
        return None
    warps = lib.k5_full_warps_per_sm(2)
    words = lib.k5_full_scratch_words(nb, lp, band_w, 2)
    return {"warps_per_sm": warps, "rows_per_lane": wavefront_dp.FULL_RPL,
            "warps_per_sm_achieved": min(warps, -(-nb // N_SMS)),
            "scratch_bytes": 4 * words}


def phase_k5_matrix(torch, np):
    """K5's matrix mode at protein_sw's shapes (protein_inputs; BLOSUM62
    at 10/1, band_w = max(Lq, Lt)): the strided PROT_HOLD-pair subset
    (row K5_matrix) against the plain version in all three alignment
    types, bit for bit, and timed in LOCAL (protein_sw's) beside the plain
    version; the whole PROT_Q x PROT_T batch timed (row K5_matrix_full);
    which tier took the calls (full_launches, where the package has it);
    a banded matrix call on part of the subset (band_w 64) against the
    plain version, which stays on the diagonal kernel."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch
    from nvbio_tpu_torch.alignment.blosum import MatrixScheme
    from nvbio_tpu_torch.alignment.types import AlignmentType
    from nvbio_tpu_torch.ops import banded_dp, wavefront_dp

    qs, ts, _ = protein_inputs(np)
    full, sub, band_w = protein_batch(torch, np, qs, ts)
    scheme = MatrixScheme(gap_open=10, gap_extend=1)
    keys = ("score", "p_end", "t_end")
    fn = wavefront_dp.wavefront_score_matrix
    worst = 0
    for atype in AlignmentType:
        kw = dict(scheme=scheme, atype=atype, band_w=band_w)
        banded_dp.reset_launch_counts()
        got = fn(*sub, **kw)
        torch.cuda.synchronize()
        n_full = getattr(fn, "full_launches", None)
        want = banded_score_batch(*sub, None, twin=True, **kw)
        err = max_abs_err(torch, [got[k] for k in keys],
                          [want[k] for k in keys])
        if err or fn.launches != 1 or n_full not in (None, 1):
            fail(f"K5_matrix {atype.name} over the subset: max_abs_err "
                 f"{err}, launches {fn.launches}, full-band {n_full}")
        worst = max(worst, err)
    log(f"[k5m] K5_matrix = its plain version over {len(sub[0])} protein "
        f"pairs, band_w {band_w}, all three types (full-band tier launches "
        f"a call: {n_full})")
    kw = dict(scheme=scheme, atype=AlignmentType.LOCAL, band_w=band_w)
    narrow = tuple(a[:512, :200] if a.dim() == 2 else a[:512].clamp(max=200)
                   for a in sub)
    nkw = dict(kw, band_w=64)
    banded_dp.reset_launch_counts()
    got = fn(*narrow, **nkw)
    torch.cuda.synchronize()
    n_full = getattr(fn, "full_launches", 0)
    want = banded_score_batch(*narrow, None, twin=True, **nkw)
    err = max_abs_err(torch, [got[k] for k in keys], [want[k] for k in keys])
    if err or fn.launches != 1 or n_full:
        fail(f"banded K5_matrix (band_w 64) differs from its plain version "
             f"({err}) or left the diagonal kernel ({n_full})")
    log("[k5m] a banded matrix call (512 pairs x 200, band_w 64) stays on "
        "the diagonal kernel and equals its plain version")

    def k5m():
        return fn(*sub, **kw)

    def plain():
        return banded_score_batch(*sub, None, twin=True, **kw)

    def k5m_full():
        return fn(*full, **kw)

    cells = int((sub[1].to(torch.int64) * sub[3]).sum())
    cells_full = int((full[1].to(torch.int64) * full[3]).sum())
    ms, pms = cuda_ms(torch, k5m, 5), cuda_ms(torch, plain, 1)
    full_ms = cuda_ms(torch, k5m_full, 3)
    nb, nb_full = len(sub[0]), len(full[0])
    bms, by, yard = gotoh_bound(cells, dp_bytes(*sub, out_bytes=12 * nb))
    fbms, fby, fyard = gotoh_bound(cells_full, dp_bytes(
        *full, out_bytes=12 * nb_full))
    occ = k5_full_occupancy(torch, nb, sub[0].shape[1], band_w)
    occ_full = k5_full_occupancy(torch, nb_full, sub[0].shape[1], band_w)
    log(f"[k5m] LOCAL subset ({nb} pairs): kernel {ms:.3f} ms "
        f"({cells / ms / 1e6:.1f} GCUPS over its {cells} Lq x Lt cells), "
        f"plain {pms:.1f} ms; bound {bms:.4f} ms ({by}); the whole batch "
        f"({nb_full} pairs): {full_ms:.3f} ms = "
        f"{cells_full / full_ms / 1e6:.1f} GCUPS, bound {fbms:.3f} ms "
        f"({fby}); full-band tier: {occ_full}")
    return {"K5_matrix": {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                          "bound_by": by, "yard_bound_ms": yard,
                          "cells": cells, "nb": nb, "max_abs_err": worst,
                          "gcups": cells / ms / 1e6, "occupancy": occ},
            "K5_matrix_full": {"ms": full_ms, "plain_ms": None,
                               "bound_ms": fbms, "bound_by": fby,
                               "yard_bound_ms": fyard, "cells": cells_full,
                               "nb": nb_full, "max_abs_err": worst,
                               "gcups": cells_full / full_ms / 1e6,
                               "occupancy": occ_full}}


def phase_protein(torch, np):
    """protein_sw at a protein-search size (protein_inputs): the CLI with
    --device cuda and the counts reset just before (K5_matrix launched,
    nothing else, every call through the full-band tier); every planted
    pair outscores its query's other pairs; K5-matrix against its plain
    version on the strided subset of the all-pairs batch, and the whole
    batch against the CLI's scores (both timed in the kernel phase,
    phase_k5_matrix); the CLI under both devices on an 8 x 64 subset, TSV
    bytes equal."""
    from nvbio_tpu_torch.alignment.batched import banded_score_batch
    from nvbio_tpu_torch.alignment.blosum import MatrixScheme
    from nvbio_tpu_torch.alignment.types import AlignmentType
    from nvbio_tpu_torch.ops import banded_dp, wavefront_dp
    from nvbio_tpu_torch.tools.protein_sw import main as protein_sw

    d = os.path.join(WORK, "protein")
    os.makedirs(d, exist_ok=True)
    Q, T = PROT_Q, PROT_T
    qs, ts, planted = protein_inputs(np)
    qn, tn = [f"q{i}" for i in range(Q)], [f"t{j}" for j in range(T)]
    write_proteins(f"{d}/q.fa", qn, qs)
    write_proteins(f"{d}/t.fa", tn, ts)

    banded_dp.reset_launch_counts()
    _, run_s, text = run_captured(protein_sw, [
        f"{d}/q.fa", f"{d}/t.fa", "-o", f"{d}/full.tsv", "--device", DEV])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in banded_dp.KERNELS.items()}
    if f"[protein_sw] {Q}x{T} alignments" not in text:
        fail(f"protein_sw printed no '{Q}x{T} alignments' line")
    if launches.pop("K5_matrix") < 1 or any(launches.values()):
        fail(f"the protein_sw run launched {launches} besides K5_matrix "
             f"{wavefront_dp.wavefront_score_matrix.launches}")
    n_k5m = wavefront_dp.wavefront_score_matrix.launches
    n_full = wavefront_dp.wavefront_score_matrix.full_launches
    if n_full != n_k5m:
        fail(f"the protein_sw run made {n_k5m} matrix-mode calls, only "
             f"{n_full} through the full-band tier")
    sc = read_tsv_scores(np, f"{d}/full.tsv", Q, T)
    margin = min(int(sc[i, j]) - int(np.delete(sc[i], j).max())
                 for i, j in planted.items())
    if margin <= 0:
        fail(f"a planted pair does not outscore its query's others "
             f"(least margin {margin})")
    log(f"[protein] protein_sw --device cuda: {Q} x {T} = {Q * T} "
        f"alignments in {run_s:.2f}s ({Q * T / run_s:.0f} alignments/s, "
        f"FASTA parse and TSV write included); K5_matrix launched {n_k5m}, "
        f"{n_full} through the full-band tier; every planted pair "
        f"outscores its query's others (least margin {margin})")

    full, sub, band_w = protein_batch(torch, np, qs, ts)
    kw = dict(scheme=MatrixScheme(gap_open=10, gap_extend=1),
              atype=AlignmentType.LOCAL, band_w=band_w)
    got = wavefront_dp.wavefront_score_matrix(*sub, **kw)
    want = banded_score_batch(*sub, None, twin=True, **kw)
    torch.cuda.synchronize()
    keys = ("score", "p_end", "t_end")
    err = max_abs_err(torch, [got[k] for k in keys], [want[k] for k in keys])
    if err:
        fail(f"K5_matrix differs from its plain version: max_abs_err {err}")
    got_full = wavefront_dp.wavefront_score_matrix(*full, **kw)
    if not np.array_equal(got_full["score"].reshape(Q, T).cpu().numpy(), sc):
        fail("K5_matrix over the whole batch differs from the CLI's TSV")
    # the plain version over the whole batch, PROT_PLAIN_CHUNK pairs a
    # call, timed as one run (its memory grows with the chunk)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    parts = [banded_score_batch(*(a[i:i + PROT_PLAIN_CHUNK] for a in full),
                                None, twin=True, **kw)
             for i in range(0, Q * T, PROT_PLAIN_CHUNK)]
    stop.record()
    torch.cuda.synchronize()
    full_plain_ms = start.elapsed_time(stop)
    full_err = max_abs_err(torch, [got_full[k] for k in keys],
                           [torch.cat([p[k] for p in parts]) for k in keys])
    if full_err:
        fail(f"K5_matrix over the whole batch differs from its plain "
             f"version: max_abs_err {full_err}")
    del parts
    log(f"[protein] K5_matrix = its plain version over {len(sub[0])} of the "
        f"batch's alignments (band_w {band_w}) and over all {Q * T} "
        f"(plain {full_plain_ms:.0f} ms in {PROT_PLAIN_CHUNK}-pair calls); "
        "the whole batch's scores = the CLI's")

    # the CLI under both devices on an 8 x 64 subset
    qi = list(range(8))
    ti = sorted({int(planted[i]) for i in qi if i in planted}
                | set(range(64)))[:64]
    write_proteins(f"{d}/q8.fa", [qn[i] for i in qi], [qs[i] for i in qi])
    write_proteins(f"{d}/t64.fa", [tn[j] for j in ti], [ts[j] for j in ti])
    secs, tsv = {}, {}
    for device in (DEV, "cpu"):
        _, secs[device], _ = run_captured(protein_sw, [
            f"{d}/q8.fa", f"{d}/t64.fa", "-o", f"{d}/sub_{device}.tsv",
            "--device", device])
        with open(f"{d}/sub_{device}.tsv", "rb") as f:
            tsv[device] = f.read()
    if tsv[DEV] != tsv["cpu"]:
        fail("protein_sw --device cuda TSV differs from --device cpu on the "
             "8 x 64 subset")
    if not np.array_equal(read_tsv_scores(np, f"{d}/sub_cpu.tsv", 8, 64),
                          sc[np.ix_(qi, ti)]):
        fail("the 8 x 64 subset's scores differ from the whole run's")
    log(f"[protein] 8 x 64 subset: --device cuda TSV = --device cpu TSV "
        f"(= the whole run's scores); {secs[DEV]:.2f}s / {secs['cpu']:.2f}s")
    return {"launches": {"K5_matrix": n_k5m, "K5_matrix_full": n_full},
            "run_s": run_s, "alignments_per_s": Q * T / run_s,
            "planted_margin": margin, "band_w": band_w, "max_abs_err": err,
            "full_plain_ms": full_plain_ms, "full_max_abs_err": full_err,
            "subset_s": secs}


def phase_wavelet(torch, np):
    """The protein FM-index: build_wavelet_fm_index over a seeded
    WFM_N-residue 20-letter text (host build, timed), then WFM_SEARCHES
    8-mer backward searches on the card (half planted, half random, an
    eighth of those with a '*' that never occurs) against the same
    searches on the CPU over the same index; the planted ranges hold
    their 8-mer's occurrence count in the text."""
    from nvbio_tpu_torch.fmindex.wavelet_fm import (build_wavelet_fm_index,
                                                    wfm_backward_search)

    rng = np.random.default_rng(SEED + 71)
    text = rng.integers(0, 20, WFM_N).astype(np.uint8)
    t0 = time.perf_counter()
    fm = build_wavelet_fm_index(text, 22)
    build_s = time.perf_counter() - t0
    dev = torch.device(DEV)
    fm_dev = fm._replace(wt=fm.wt._replace(**{
        k: getattr(fm.wt, k).to(dev)
        for k in ("words", "block_rank", "node_start", "node_ones")}),
        C=fm.C.to(dev))
    L, n = 8, WFM_SEARCHES
    starts = rng.integers(0, WFM_N - L, n // 2)
    seeds = np.concatenate([
        text[starts[:, None] + np.arange(L)],
        rng.integers(0, 20, (n - n // 2, L))]).astype(np.int32)
    star = np.arange(n // 2, n, 8)
    seeds[star, 4] = 21
    sd = torch.from_numpy(seeds).to(dev)

    def search():
        return wfm_backward_search(fm_dev, sd)

    lo, hi = search()
    torch.cuda.synchronize()
    ms = cuda_ms(torch, search, 5)
    t0 = time.perf_counter()
    lo_c, hi_c = wfm_backward_search(fm, torch.from_numpy(seeds))
    cpu_s = time.perf_counter() - t0
    if not (torch.equal(lo.cpu(), lo_c) and torch.equal(hi.cpu(), hi_c)):
        fail("wfm_backward_search on the card differs from the CPU")
    cnt = (hi_c - lo_c).numpy()
    # every 8-mer's count in the text, from sorted base-20 keys
    win = np.lib.stride_tricks.sliding_window_view(text, L).astype(np.int64)
    keys = np.sort(win @ (20 ** np.arange(L, dtype=np.int64)))
    q = seeds[: n // 2].astype(np.int64) @ (20 ** np.arange(L,
                                                          dtype=np.int64))
    want = (np.searchsorted(keys, q, "right") - np.searchsorted(keys, q))
    if not np.array_equal(cnt[: n // 2], want) or cnt[star].any():
        fail("wavelet FM ranges disagree with the text's 8-mer counts")
    log(f"[wavelet] {WFM_N}-residue text: host build {build_s:.2f}s "
        f"(SA-IS, BWT, wavelet tree); {n} 8-mer searches on the card "
        f"{ms:.3f} ms ({n / ms * 1e3:.0f} searches/s), the CPU "
        f"{cpu_s:.2f}s; (lo, hi) equal, planted counts = the text's "
        f"({int(cnt[: n // 2].sum())} occurrences), "
        f"{int((cnt[n // 2:] > 0).sum())} random 8-mers found")
    return {"n": WFM_N, "build_s": build_s, "searches": n, "ms": ms,
            "searches_per_s": n / ms * 1e3, "cpu_s": cpu_s}


def substitution_reads(np, g, n_reads, read_len, rate, rng):
    """simulate_reads' model without indels, vectorised: uniform starts,
    both strands, each base substituted to another with probability
    ``rate``.  Returns (reads int8, error-free reads uint8, quals)."""
    starts = rng.integers(0, len(g) - read_len, n_reads)
    truth = g[starts[:, None] + np.arange(read_len)].astype(np.uint8)
    rc = rng.integers(0, 2, n_reads).astype(bool)
    truth[rc] = (3 - truth[rc])[:, ::-1]
    err = rng.random(truth.shape) < rate
    reads = truth.copy()
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()))) % 4
    quals = rng.integers(25, 41, truth.shape).astype(np.uint8)
    return reads.astype(np.int8), truth, quals


def phase_corrector(torch, np):
    """The read corrector at E. coli's length: CORR_COV x of 100 bp reads
    with 1 % substitutions, k 15, passes 1 and 2 on the card at
    --log2-slots 24 (the CLI's default) and at CORR_BIG_SLOTS, rounds 1
    and 2: corrections, the per-base error rate against the simulated
    truth before and after, reads/s; and correct_reads --rounds 2 on
    CORR_CLI_READS reads of a 30x region under --device cuda and
    --device cpu, FASTQ bytes equal."""
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.models.corrector import Corrector
    from nvbio_tpu_torch.tools.correct_reads import main as correct_reads
    from nvbio_tpu_torch.utils.simulate import random_genome

    d = os.path.join(WORK, "corrector")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(SEED + 72)
    g = random_genome(ECOLI_BP, seed=SEED + 73)
    n = ECOLI_BP * CORR_COV // 100
    reads, truth, _ = substitution_reads(np, g, n, 100, 0.01, rng)
    lens = np.full(n, 100, np.int32)
    spans = [slice(s, s + CORR_BATCH) for s in range(0, n, CORR_BATCH)]
    before = float((reads != truth).mean())
    runs = {}
    for slots in (24, CORR_BIG_SLOTS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        corr = Corrector.build((reads[b] for b in spans),
                               (lens[b] for b in spans), k=15,
                               log2_slots=slots, device=DEV)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for rounds in (1, 2):
            t0 = time.perf_counter()
            outs = [corr.correct(reads[b], lens[b], rounds=rounds)
                    for b in spans]
            correct_s = time.perf_counter() - t0
            fixed = np.concatenate([o[0] for o in outs])
            n_corr = int(sum(o[1].sum() for o in outs))
            after = float((fixed != truth).mean())
            r = runs[f"slots{slots}_rounds{rounds}"] = {
                "corrections": n_corr, "error_before": before,
                "error_after": after, "build_s": build_s,
                "correct_s": correct_s,
                "reads_per_s": n / (build_s + correct_s),
                "peak_bytes": torch.cuda.max_memory_allocated()}
            log(f"[corrector] {n} reads, --log2-slots {slots}, --rounds "
                f"{rounds}: {n_corr} corrections, per-base error "
                f"{before:.5f} -> {after:.5f}; pass 1 {build_s:.2f}s, pass 2 "
                f"{correct_s:.2f}s: {r['reads_per_s']:.0f} reads/s "
                f"(batches of {CORR_BATCH}); peak "
                f"{r['peak_bytes'] / 2**30:.2f} GiB")
        del corr
    if runs[f"slots{CORR_BIG_SLOTS}_rounds2"]["error_after"] > 0.2 * before:
        fail("the sized sketch's two rounds left over a fifth of the errors")

    # the CLI under both devices: reads of a region at 30x
    m = CORR_CLI_READS
    r2, _, q2 = substitution_reads(np, g[: m * 100 // 30 + 100], m, 100,
                                   0.01, rng)
    write_fastq(f"{d}/r.fq", [(f"r{i}", r2[i].astype(np.uint8), q2[i])
                              for i in range(m)])
    secs, fq, said = {}, {}, {}
    for device in (DEV, "cpu"):
        _, secs[device], said[device] = run_captured(correct_reads, [
            f"{d}/r.fq", f"{d}/{device}.fq", "--rounds", "2", "--device",
            device])
        with open(f"{d}/{device}.fq", "rb") as f:
            fq[device] = f.read()
    if fq[DEV] != fq["cpu"] or said[DEV] != said["cpu"]:
        fail("correct_reads --device cuda FASTQ differs from --device cpu")
    log(f"[corrector] correct_reads --rounds 2 on {m} reads: cuda FASTQ = "
        f"cpu FASTQ; {secs[DEV]:.2f}s / {secs['cpu']:.2f}s "
        f"({m / secs[DEV]:.0f} / {m / secs['cpu']:.0f} reads/s, FASTQ "
        "parse and write included)")
    return {"reads": n, "runs": runs, "cli_reads": m, "cli_s": secs,
            "cli_line": said["cpu"].strip()}


def phase_bwa(torch, np):
    """BWA index interop at E. coli's length, in two contigs with N runs:
    build_index, bwa_export --reverse, bwa_import: every imported .npz
    array and the contig table equal the direct build's; map_reads
    --device cuda of BWA_READS reads against both indexes gives the same
    SAM records."""
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.bwa_export import main as bwa_export
    from nvbio_tpu_torch.tools.bwa_import import main as bwa_import
    from nvbio_tpu_torch.tools.map_reads import main as mapr
    from nvbio_tpu_torch.utils.simulate import random_genome

    d = os.path.join(WORK, "bwa")
    os.makedirs(d, exist_ok=True)
    g = random_genome(ECOLI_BP, seed=SEED + 74)
    cut = ECOLI_BP * 2 // 3
    for a, b in ((cut // 3, cut // 3 + 100), (2 * cut // 3, 2 * cut // 3 + 7),
                 (cut + 5_000, cut + 5_050)):
        g[a:b] = 4
    write_fasta(f"{d}/g.fa", [("contig1", g[:cut]), ("contig2", g[cut:])])
    secs = {}
    for name, fn, args in (
            ("build_index", build, [f"{d}/g.fa", f"{d}/g.npz"]),
            ("bwa_export", bwa_export, [f"{d}/g.npz", f"{d}/bw",
                                        "--reverse"]),
            ("bwa_import", bwa_import, [f"{d}/bw", f"{d}/gi.npz"])):
        _, secs[name], text = run_captured(fn, args)
    if "bwt cross-check: PASSED" not in text:
        fail("bwa_import did not cross-check the exported .bwt")
    bad = [k for k in npz_diff(np, f"{d}/gi.npz", f"{d}/g.npz")
           if k != "meta"]
    metas = []
    for f in ("g.npz", "gi.npz"):
        with np.load(f"{d}/{f}") as z:
            meta = json.loads(bytes(z["meta"]).decode())
            metas.append({k: meta.get(k) for k in (
                "contig_names", "contig_lens", "amb", "sa_sample", "sa_bi",
                "lut_k")})
    if bad or metas[0] != metas[1]:
        fail(f"the imported index differs from the direct build: {bad}, "
             f"{metas}")
    rng = np.random.default_rng(SEED + 75)
    reads, _, quals = substitution_reads(np, np.where(g < 4, g, 0), BWA_READS,
                                         100, 0.02, rng)
    write_fastq(f"{d}/r.fq", [(f"r{i}", reads[i].astype(np.uint8), quals[i])
                              for i in range(BWA_READS)])
    recs = {}
    for idx in ("g", "gi"):
        t0 = time.perf_counter()
        mapr(["-x", f"{d}/{idx}.npz", "-U", f"{d}/r.fq", "-S",
              f"{d}/{idx}.sam", "--device", DEV])
        secs[f"map_{idx}"] = time.perf_counter() - t0
        recs[idx] = sam_records(f"{d}/{idx}.sam")
    n_al = sum(r.split("\t")[1] != "4" for r in recs["g"])
    if recs["g"] != recs["gi"] or len(recs["g"]) != BWA_READS:
        fail("map_reads against the imported index differs from the direct "
             "build's SAM")
    if n_al < 0.95 * BWA_READS:
        fail(f"only {n_al} of {BWA_READS} reads aligned")
    log(f"[bwa] {ECOLI_BP} bp in 2 contigs with 3 N runs: build_index "
        f"{secs['build_index']:.2f}s, bwa_export --reverse "
        f"{secs['bwa_export']:.2f}s, bwa_import {secs['bwa_import']:.2f}s; "
        f"every imported array and the contig table = the direct build's; "
        f"{BWA_READS} reads mapped --device cuda against both ({n_al} "
        f"aligned): identical SAM records")
    return {"seconds": secs, "aligned": n_al}


def kernel_phases(torch, np, result, only=None):
    """The kernel phases (3, 4, 4b, 4c, 9, 10, K1 at bench.py's shape, 14)
    into ``result``: every kernel against its plain version, timed.  With
    ``only`` (row names of timed_rows), just the phases that give them."""
    def run(*rows):
        return only is None or any(r in only for r in rows)

    k = result["kernels"] = {}
    if run("K1", "K2", "K3"):
        k.update(phase_kernels(torch, np))
    if run("K4", "K4_dirs"):
        k["K4"] = phase_k4(torch, np)
    if run("K4_wide", "K4_wide_semi", "K4_wide_150"):
        k.update(phase_k4_wide(torch, np))
    result["path_shapes"] = (phase_path_shapes(torch, np)
                             if run("K2_path", "K3_path", "K4_rescue")
                             else {})
    if run("K5", "K5_dirs"):
        k.update(phase_k5(torch, np))
    if run(*MYERS_SHAPES):
        k.update(phase_k6(torch, np, only))
    torch.cuda.empty_cache()
    if run("K5_matrix", "K5_matrix_full"):
        k.update(phase_k5_matrix(torch, np))
    torch.cuda.empty_cache()
    result["bench_k1"] = (phase_bench_k1(torch, np)
                          if run("K1_bench", "K1_w31") else {})
    torch.cuda.empty_cache()
    if run(*K7_ROWS.values()):
        k["K7"] = phase_k7(torch, np, only)
    torch.cuda.empty_cache()
    result["rows"] = timed_rows(result)


def timed_rows(result):
    """Every timed kernel row of the kernel phases that ran, by name: its
    ms, the bound (GOTOH_OPS a cell for banded Gotoh), the bound at the
    earlier records' yardstick, the time as issued where measured, and
    the group kernel's block shape for the K1-K4 rows; logged one a
    line."""
    k, ps, bk = result["kernels"], result["path_shapes"], result["bench_k1"]
    rows = {n: k[n] for n in ("K1", "K2", "K3", "K4", "K4_wide",
                              "K4_wide_semi", "K4_wide_150", "K5",
                              "K5_dirs", *MYERS_SHAPES, "K5_matrix",
                              "K5_matrix_full") if n in k}
    rows.update(bk)
    if "K4" in k:
        k4 = k["K4"]
        rows["K4_dirs"] = {"ms": k4["dirs_ms"], "bound_ms": k4["dirs_bound_ms"],
                           "yard_bound_ms": k4["dirs_yard_bound_ms"]}
    rows.update(ps)
    if "K7" in k:
        rows.update({K7_ROWS[n]: k["K7"][n] for n in K7_SHAPES
                     if n in k["K7"]})
    occ = {"K1": occupancy("K1", BAND_W, NB, False),
           "K2": occupancy("K2", BAND_W, NB, True),
           "K3": occupancy("K3", BAND_W, NB, False),
           "K1_bench": occupancy("K1", BAND_W, BENCH_NB, False),
           "K1_w31": occupancy("K1", 31, BENCH_NB // 8, False),
           "K4": occupancy("K4", LONG_W, LONG_NB, False),
           "K4_dirs": occupancy("K4", LONG_W, LONG_DIRS_NB, True)}
    occ.update({n: r["occupancy"] for n, r in ps.items()})
    occ.update({n: k[n]["occupancy"] for n in ("K4_wide", "K4_wide_semi",
                                                "K4_wide_150") if n in k})
    occ.update({n: k[n]["occupancy"] for n in ("K5_matrix", "K5_matrix_full",
                                                "K5_dirs", *MYERS_SHAPES)
                if n in k and "occupancy" in k[n]})
    occ.update({K7_ROWS[n]: k["K7"][n]["occupancy"] for n in K7_SHAPES
                if "K7" in k and n in k["K7"]})
    out = {}
    for name, r in rows.items():
        o = out[name] = {"ms": r["ms"], "bound_ms": r["bound_ms"],
                         "yard_bound_ms": r.get("yard_bound_ms"),
                         "launch_ms": r.get("launch_ms"),
                         "occupancy": occ.get(name)}
        yard = (f", yardstick share {o['yard_bound_ms'] / o['ms']:.3f}"
                if o["yard_bound_ms"] else "")
        issued = (f", as issued {o['launch_ms']:.4f} ms"
                  if o["launch_ms"] else "")
        warps = (f", {o['occupancy']['warps_per_sm_achieved']} warps an SM"
                 if (o["occupancy"] or {}).get("warps_per_sm_achieved")
                 else "")
        log(f"[rows] {name}: {o['ms']:.4f} ms, bound {o['bound_ms']:.4f} ms"
            f", share {o['bound_ms'] / o['ms']:.3f}{yard}{issued}{warps}")
    return out


def times_main(root, only=None):
    """--times: the card, the build and the kernel phases of the package
    in ``root`` (only those of the rows ``only`` names, if given); prints
    their rows as one JSON line."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    smi, _ = phase_card(torch)
    torch.cuda.set_device(0)
    result = {}
    build_s, tiers = phase_build()
    kernel_phases(torch, np, result, only)
    log(json.dumps({"root": root, "nvidia_smi": smi, "build_s": build_s,
                    "group_tiers": tiers, "rows": result["rows"]}))


def turns_main(parent, only=None):
    """--turns PARENT: --times on the parent checkout and on this one in
    turns (parent, this, this, parent), one process each, on one card;
    the rows to OUT/turns.json."""
    runs = []
    rows = ["--rows", ",".join(only)] if only else []
    for root in (parent, ROOT, ROOT, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times", root,
             *rows], capture_output=True, text=True, timeout=1200)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-4000:])
            fail(f"--times {root} exited with {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "turns.json"), "w") as f:
        json.dump(runs, f, indent=1)
    log(runs[0]["nvidia_smi"])
    for name in runs[0]["rows"]:
        rs = [r["rows"][name] for r in runs]
        ms = [r["ms"] for r in rs]
        b, yard = rs[1]["bound_ms"], rs[1]["yard_bound_ms"]
        line = (f"[turns] {name}: parent {ms[0]:.4f} / {ms[3]:.4f} ms, this "
                f"tree {ms[1]:.4f} / {ms[2]:.4f} ms; bound {b:.4f} ms, share"
                f" parent {2 * b / (ms[0] + ms[3]):.3f}, this tree "
                f"{2 * b / (ms[1] + ms[2]):.3f}")
        if yard:
            line += (f" (yardstick: {2 * yard / (ms[0] + ms[3]):.3f}, "
                     f"{2 * yard / (ms[1] + ms[2]):.3f})")
        if rs[0]["launch_ms"]:
            line += (f"; as issued parent {rs[0]['launch_ms']:.4f} / "
                     f"{rs[3]['launch_ms']:.4f}, this tree "
                     f"{rs[1]['launch_ms']:.4f} / {rs[2]['launch_ms']:.4f} ms")
        log(line)


def main():
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "nvbio_tpu_torch")):
        fail("run from a checkout of the repository (nvbio_tpu_torch/ "
             "not found beside this script)")
    args = sys.argv[1:]
    only = None
    if len(args) == 4 and args[2] == "--rows":
        only = args[3].split(",")
        args = args[:2]
    if args[:1] in (["--times"], ["--turns"]) and len(args) == 2:
        root = os.path.abspath(args[1])
        if not os.path.isdir(os.path.join(root, "nvbio_tpu_torch")):
            fail(f"{root} holds no nvbio_tpu_torch/")
        return (times_main if args[0] == "--times" else turns_main)(root,
                                                                    only)
    if args or only:
        fail("usage: chip_smoke.py [--times ROOT | --turns PARENT_ROOT] "
             "[--rows NAME,...]")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    smi, mhz = phase_card(torch)
    torch.cuda.set_device(0)
    result = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "max_sm_mhz": mhz,
              "int32_peak": INT32_PEAK}
    try:
        result["build_s"], result["group_tiers"] = phase_build()
        result["k5_full_build"] = K5_FULL_BUILD
        result["k5_band_build"] = K5_BAND_BUILD
        result["k5_dirs_build"] = K5_DIRS_BUILD
        kernel_phases(torch, np, result)
        result["sw_benchmark"] = phase_sw_benchmark(torch)
        result["tool_shapes"] = phase_tool_shapes(torch, np)
        torch.cuda.empty_cache()
        result["pass3"] = phase_pass3(torch, np)
        torch.cuda.empty_cache()
        result["wide_band"] = phase_wide_band(torch, np)
        torch.cuda.empty_cache()
        result["self_test"] = phase_self_test(torch)
        torch.cuda.empty_cache()
        result["golden_launches"] = phase_golden(torch)
        result["golden_pe_launches"] = phase_golden_pe(torch)
        result["real"], genome, sim = phase_real_size(torch, np)
        torch.cuda.empty_cache()
        result["sufsort"] = phase_sufsort(torch, np, genome)
        torch.cuda.empty_cache()
        result["local"] = phase_local(torch, np, sim)
        torch.cuda.empty_cache()
        result["n1"] = phase_n1(torch, np, genome, sim)
        torch.cuda.empty_cache()
        result["all"] = phase_all(torch, np, sim)
        torch.cuda.empty_cache()
        result["mem_qmap"] = phase_mem_qmap(torch, np, sim)
        del sim
        torch.cuda.empty_cache()
        result["pe"] = phase_pe(torch, np, genome)
        torch.cuda.empty_cache()
        result["pe_local"] = phase_pe_local(torch, np)
        torch.cuda.empty_cache()
        result["io_flags"] = phase_io_flags(torch, np)
        torch.cuda.empty_cache()
        result["sharded"] = phase_sharded(torch, np)
        torch.cuda.empty_cache()
        result["mesh"] = phase_mesh(torch, np)
        torch.cuda.empty_cache()
        result["fm_server"] = phase_fm_server(torch, np)
        torch.cuda.empty_cache()
        result["long"] = phase_long_reads(torch, np, genome)
        torch.cuda.empty_cache()
        result["protein"] = phase_protein(torch, np)
        torch.cuda.empty_cache()
        result["wavelet"] = phase_wavelet(torch, np)
        torch.cuda.empty_cache()
        result["corrector"] = phase_corrector(torch, np)
        torch.cuda.empty_cache()
        result["bwa"] = phase_bwa(torch, np)
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
             "pass 3": result["pass3"]["launches"],
             "int16 opt-in phase": {"K7": result["kernels"]["K7"]["launches"]},
             "--local run": result["local"]["launches"],
             "-N 1 run": result["n1"]["launches"],
             "-a run": result["all"]["launches"],
             "PE --local run": result["pe_local"]["launches"],
             "PE --local run (sweep)": {
                 "K4_wide": result["pe_local"]["sweep_launches"]},
             "flagged SE run": result["io_flags"]["launches"],
             "flagged PE run": result["io_flags"]["pe_launches"],
             "protein_sw run": result["protein"]["launches"],
             "Myers phase (warp tier)": {
                 n: result["kernels"][n]["warp_launches"]
                 for n in MYERS_SHAPES if n != "K6"}}
    csrc = "nvbio_tpu_torch/ops/csrc/"
    kernels = []
    # the kernel symbol each row times, in its source
    symbols = {"K4_wide": "k4_sweep_kernel", "K6": "k6_kernel",
               **{n: "k6_warp_kernel" for n in MYERS_SHAPES if n != "K6"},
               "K5": "k5_band_kernel", "K5_dirs": "k5_band_dirs_kernel",
               "K7": "k7_group_kernel",
               "K5_matrix": "k5_full_kernel",
               "K5_matrix_full": "k5_full_kernel"}
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
            ("K4_wide", "long_gotoh.cu", "nvbio_tpu/ops/long_dp.py:218",
             "PE --local run (sweep)"),
            ("K5", "wavefront_gotoh.cu", "nvbio_tpu/ops/wavefront_dp.py:349",
             "sw_benchmark --long"),
            ("K5_dirs", "wavefront_gotoh.cu",
             "nvbio_tpu/ops/wavefront_dp.py:321", "pass 3"),
            ("K6", "myers.cu", "nvbio_tpu/ops/myers_pallas.py:187",
             "sw_benchmark --long"),
            *((n, "myers.cu", "nvbio_tpu/ops/myers_pallas.py:187",
               "Myers phase (warp tier)")
              for n in MYERS_SHAPES if n != "K6"),
            ("K7", "banded_gotoh16.cu", "nvbio_tpu/ops/banded_dp.py:117",
             "int16 opt-in phase"),
            ("K5_matrix", "wavefront_gotoh.cu",
             "nvbio_tpu/alignment/extra.py:40 -> "
             "nvbio_tpu/alignment/batched.py:41", "protein_sw run"),
            ("K5_matrix_full", "wavefront_gotoh.cu",
             "nvbio_tpu/alignment/extra.py:40 -> "
             "nvbio_tpu/alignment/batched.py:41", "protein_sw run")):
        k = result["kernels"][name]
        if name == "K5_matrix_full":  # its plain version over the batch
            k = dict(k, plain_ms=result["protein"]["full_plain_ms"],
                     max_abs_err=result["protein"]["full_max_abs_err"])
        if name in ("K2", "K3"):  # timed at the shape the path calls it
            p = result["path_shapes"][f"{name}_path"]
            k = dict(p, max_abs_err=max(k["max_abs_err"], p["max_abs_err"]))
        n = paths[path][name]
        if n < 1:
            fail(f"the {path} never launched {name}: {paths[path]}")
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        **({"symbol": symbols[name]} if name in symbols
                           else {}),
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
