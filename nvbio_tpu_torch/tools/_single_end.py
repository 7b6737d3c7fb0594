"""The run shared by the single-end seed-and-extend CLIs (mem_map,
qmap): index load, the mapper's stream, SAM or BAM out, --stats."""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np


def run(args, argv, program: str, make_mapper, **param_kw) -> int:
    """Map ``args.U`` against ``args.index`` with the mapper that
    ``make_mapper(fm, ssa, genome, params, contigs)`` returns; the
    ``MapperParams`` get the CLI's common options and ``param_kw``.

    --stats writes the reference's MappingStats summary plus the port's
    device, load_s (index load and mapper set-up), map_s (from opening
    the output to closing it) and reads_per_s (reads / map_s)."""
    import torch

    from ..device import resolve_device
    from ..io.bam import BamWriter
    from ..io.index_file import load_index
    from ..io.sam import SamWriter
    from ..io.sequence import ReadBatchIterator
    from ..models.params import MapperParams
    from ..strings.string_set import pack_reads
    from ..utils.stats import MappingStats

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    fm, ssa, genome, meta = load_index(args.index, device=device)
    params = MapperParams(local=args.local, batch_size=args.batch,
                          sa_sample=meta["sa_sample"],
                          max_read_len=args.max_read_len, **param_kw)
    contigs = {
        "names": meta["contig_names"],
        "starts": np.concatenate(
            [[0], np.cumsum(meta["contig_lens"][:-1])]).astype(np.int64),
        "lens": np.array(meta["contig_lens"], dtype=np.int64),
    }
    mapper = make_mapper(fm, ssa, genome, params, contigs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0

    def packed():
        for names, seqs, quals in ReadBatchIterator(args.U, args.batch):
            reads, lens, qmat, _ = pack_reads(seqs, quals,
                                              max_len=args.max_read_len)
            yield names, reads, lens, qmat

    stats = MappingStats()
    t1 = time.perf_counter()
    # BAM for a .bam path, as the reference chooses; SAM (.gz ok) else
    writer_cls = BamWriter if args.sam.endswith(".bam") else SamWriter
    with writer_cls(args.sam, meta["contig_names"], meta["contig_lens"],
                    cmdline=" ".join(argv if argv is not None
                                     else sys.argv[1:]),
                    program=program) as writer:
        with stats.timer("total"), stats.timer("compute"):
            for names, reads, lens, qmat, results in \
                    mapper.map_stream(packed()):
                stats.observe(results)
                with stats.timer("output"):
                    for rec in mapper.to_sam_records(names, reads, lens,
                                                     qmat, results):
                        writer.write(rec)
    t_map = time.perf_counter() - t1
    report = stats.summary()
    stats.report(file=sys.stderr)
    report.update({
        "device": str(device),
        "load_s": t_load,
        "map_s": t_map,
        "reads_per_s": stats.reads / t_map if t_map > 0 else math.nan,
    })
    print(f"[{program}] {stats.reads} reads ({stats.aligned} aligned) on "
          f"{device} in {t_map:.2f}s after {t_load:.2f}s index load and "
          "set-up", file=sys.stderr)
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(report, f, indent=2)
    return 0
