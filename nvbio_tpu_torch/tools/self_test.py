"""Runnable install sanity check (nvbio-test equivalent).

Port of ``nvbio_tpu/tools/self_test.py``, with its five checks under the
same names and thresholds: build a small index in-process, map simulated
reads (SE + PE), check the alignment rate and true-locus accuracy, the
plain banded DP against the scalar oracle, (on a card) the K1 kernel
against its plain version, and the device suffix sort against SA-IS.

    python -m nvbio_tpu_torch.tools.self_test [--device cuda|cpu] [--quick]

Exit code 0 = all checks passed.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="self_test", description=__doc__)
    p.add_argument("--quick", action="store_true",
                   help="smaller genome/read count (~30 s on CPU)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never picked implicitly")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..device import resolve_device

    dev = resolve_device(args.device)
    n_bp = 200_000 if args.quick else 1_000_000
    n_reads = 200 if args.quick else 2000
    failures = []

    def check(name, ok, detail=""):
        status = "ok" if ok else "FAIL"
        print(f"[self_test] {name:34s} {status}  {detail}",
              file=sys.stderr, flush=True)
        if not ok:
            failures.append(name)

    t0 = time.time()
    card = (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
            else "")
    print(f"[self_test] backend: torch {torch.__version__} on {dev}{card}",
          file=sys.stderr)

    # 1. index build + SE mapping accuracy
    from ..fmindex.build import build_fm_arrays
    from ..io.index_file import index_from_numpy
    from ..models import Mapper, MapperParams
    from ..utils.simulate import random_genome, simulate_reads

    genome = random_genome(n_bp, seed=7)
    fm_f, ssa_f = build_fm_arrays(genome, sa_sample=4, bi_sample=True)
    fm, ssa, g, _ = index_from_numpy(fm_f, (*ssa_f, 4, 1), genome,
                                     device=dev)
    sim = simulate_reads(genome, n_reads, 100, error_rate=0.01, seed=8)
    lens = np.full(n_reads, 100, np.int32)
    m = Mapper(fm, ssa, g, params=MapperParams(batch_size=min(n_reads, 4096)))
    res = m.map_reads(sim["seqs"].astype(np.uint8), lens, sim["quals"])
    aligned = sum(r.aligned for r in res)
    true_locus = sum(
        r.aligned and abs(r.pos - int(tp)) <= 3
        for r, tp in zip(res, sim["true_pos"]))
    check("SE alignment rate", aligned >= 0.98 * n_reads,
          f"{aligned}/{n_reads}")
    check("SE true-locus accuracy", true_locus >= 0.97 * n_reads,
          f"{true_locus}/{n_reads}")

    # 2. PE proper pairs
    from ..models.paired import PairedMapper
    from ..utils.simulate import simulate_pairs

    np_pairs = max(n_reads // 4, 64)
    simp = simulate_pairs(genome, np_pairs, 100, insert_mean=300,
                          insert_sd=30, seed=9)
    lp = np.full(np_pairs, 100, np.int32)
    pm = PairedMapper(fm, ssa, g,
                      params=MapperParams(batch_size=min(np_pairs, 4096),
                                          maxins=500))
    r1, r2, info = pm.map_pairs(simp["seqs1"].astype(np.uint8), lp,
                                simp["quals1"],
                                simp["seqs2"].astype(np.uint8), lp,
                                simp["quals2"])
    proper = sum(i["proper"] for i in info)
    check("PE proper pairs", proper >= 0.97 * np_pairs,
          f"{proper}/{np_pairs}")

    # 3. DP engine: the plain banded Gotoh score vs the scalar oracle
    from ..alignment import AlignmentType, GotohScheme, align_oracle
    from ..alignment.batched import banded_score_batch

    rng = np.random.default_rng(10)
    pats = rng.integers(0, 4, (8, 100)).astype(np.int8)
    texts = rng.integers(0, 4, (8, 130)).astype(np.int8)
    texts[:, 15:115] = pats
    for r in range(8):
        texts[r, rng.integers(15, 115)] = rng.integers(0, 4)
    quals = np.full((8, 100), 35, np.int32)
    scheme = GotohScheme()
    dp_args = (torch.from_numpy(pats).to(dev),
               torch.full((8,), 100, dtype=torch.int32, device=dev),
               torch.from_numpy(texts).to(dev),
               torch.full((8,), 130, dtype=torch.int32, device=dev),
               torch.from_numpy(quals.astype(np.uint8)).to(dev))
    dp_kw = dict(scheme=scheme, atype=AlignmentType.SEMI_GLOBAL, band_w=15)
    out = banded_score_batch(*dp_args, **dp_kw)
    dp_ok = all(
        int(out["score"][r]) == align_oracle(
            pats[r], texts[r], scheme, AlignmentType.SEMI_GLOBAL,
            band=15, quals=quals[r]).score
        for r in range(8))
    check("banded Gotoh vs oracle", dp_ok)

    # 4. the K1 kernel against its plain version (card only; the CPU ran
    # the plain version above)
    if dev.type == "cuda":
        from ..ops.banded_dp import banded_score

        outk = banded_score(*dp_args, **dp_kw)
        check("K1 == its plain version",
              all(bool(torch.equal(outk[k], out[k]))
                  for k in ("score", "p_end", "t_end")))

    # 5. suffix sorting: device prefix-doubling vs host SA-IS
    from ..sufsort import suffix_array
    from ..sufsort.device import suffix_array_device

    t = rng.integers(0, 4, 50_000).astype(np.uint8)
    check("device sufsort vs SA-IS",
          bool((suffix_array_device(t, device=dev)
                == suffix_array(t)).all()))

    print(f"[self_test] {time.time() - t0:.1f}s, "
          f"{len(failures)} failure(s)", file=sys.stderr)
    if failures:
        print("FAILED: " + ", ".join(failures))
        return 1
    print("self_test: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
