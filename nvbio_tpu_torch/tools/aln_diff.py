"""SAM-vs-SAM diff tool (nvbio-aln-diff equivalent).

Ref parity: nvbio-aln-diff/ (SURVEY.md §3.9) — the reference's
output-equivalence harness: compare two SAM files record by record
(position/strand/MAPQ/CIGAR/score), print distribution stats.  Text +
JSON instead of the reference's HTML report.

Port of ``nvbio_tpu/tools/aln_diff.py`` (the standard library and the
port's ``utils/html.py``):

    python -m nvbio_tpu_torch.tools.aln_diff a.sam b.sam \\
        [--pos-tolerance N] [--json out.json] [--html out.html]
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys
from collections import defaultdict


def _read_sam(path):
    recs = {}
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.rstrip("\n").split("\t")
            flag = int(c[1])
            key = (c[0], flag & 0xC0)  # qname + read1/read2 bits
            recs[key] = {
                "flag": flag,
                "rname": c[2],
                "pos": int(c[3]),
                "mapq": int(c[4]),
                "cigar": c[5],
                "as": next((int(x.split(":")[2]) for x in c[11:]
                            if x.startswith("AS:")), None),
            }
    return recs


def compare(a, b, pos_tolerance=0):
    stats = defaultdict(int)
    mapq_diff = defaultdict(int)
    keys = set(a) | set(b)
    for k in keys:
        ra, rb = a.get(k), b.get(k)
        if ra is None or rb is None:
            stats["missing"] += 1
            continue
        stats["both"] += 1
        ua, ub = ra["flag"] & 0x4, rb["flag"] & 0x4
        if ua and ub:
            stats["both_unmapped"] += 1
            continue
        if ua != ub:
            stats["mapped_only_in_" + ("B" if ua else "A")] += 1
            continue
        stats["both_mapped"] += 1
        same_pos = (
            ra["rname"] == rb["rname"]
            and abs(ra["pos"] - rb["pos"]) <= pos_tolerance
            and (ra["flag"] & 0x10) == (rb["flag"] & 0x10)
        )
        stats["same_pos"] += same_pos
        if same_pos:
            stats["same_cigar"] += ra["cigar"] == rb["cigar"]
            if ra["as"] is not None and rb["as"] is not None:
                stats["same_score"] += ra["as"] == rb["as"]
        mapq_diff[ra["mapq"] - rb["mapq"]] += 1
    return dict(stats), dict(sorted(mapq_diff.items()))


def main(argv=None):
    p = argparse.ArgumentParser(prog="aln_diff", description=__doc__)
    p.add_argument("sam_a")
    p.add_argument("sam_b")
    p.add_argument("--pos-tolerance", type=int, default=0)
    p.add_argument("--json", help="write JSON report here")
    p.add_argument("--html", help="write HTML report here (ref: the "
                   "reference's aln-diff HTML output over basic/html.h)")
    args = p.parse_args(argv)
    a = _read_sam(args.sam_a)
    b = _read_sam(args.sam_b)
    stats, mq = compare(a, b, args.pos_tolerance)
    report = {"stats": stats, "mapq_delta_hist": mq}
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    if args.html:
        from ..utils.html import page, table, bar_chart

        doc = page(
            f"aln-diff: {args.sam_a} vs {args.sam_b}",
            [
                ("Comparison", table(sorted(stats.items()),
                                     header=("category", "count"))),
                ("MAPQ delta histogram (A - B)", bar_chart(
                    [(str(k), v) for k, v in mq.items()]
                )),
            ],
        )
        with open(args.html, "w") as f:
            f.write(doc)
    # exit 0 if positionally identical, 1 otherwise (CI-friendly)
    return 0 if stats.get("same_pos", 0) == stats.get("both_mapped", -1) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
