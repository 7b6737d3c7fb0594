"""Mapping statistics and per-stage timing.

Ref parity: nvBowtie/bowtie2/cuda/stats.h (``Stats``, per-stage timers,
mapped%-by-MAPQ histograms) + basic/timer.h (``Timer``).  Reports to
console and JSON instead of the reference's HTML writer.

A copy of ``nvbio_tpu/utils/stats.py`` for the PyTorch port (package-relative
imports only), which imports nothing of ``nvbio_tpu``.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


class Timer:
    """Accumulating wall timer (ref: basic/timer.h)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.total += time.time() - self._t0
        self.count += 1


@dataclass
class MappingStats:
    """Counters for one mapping run (ref: stats.h Stats)."""

    reads: int = 0
    aligned: int = 0
    unique: int = 0  # aligned with no second-best
    proper_pairs: int = 0
    discordant: int = 0
    # locate-budget slots dropped on overflow (params.locate_frac /
    # mm_locate_frac < 1.0 on hit-dense batches; 0 = no hits lost)
    locate_dropped: int = 0
    # effort-escalation pressure (ref: nvBowtie max_effort rounds):
    # reads whose round-1 budgets overflowed, and re-maps performed by
    # the escalation ladder (a read re-mapped twice counts twice)
    overflowed: int = 0
    escalated: int = 0
    mapq_hist: dict = field(default_factory=lambda: defaultdict(int))
    timers: dict = field(default_factory=dict)

    def timer(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer()
        return self.timers[name]

    def observe(self, results):
        for r in results:
            self.reads += 1
            if r.aligned:
                self.aligned += 1
                if r.second is None:
                    self.unique += 1
                self.mapq_hist[min(r.mapq // 10 * 10, 40)] += 1

    @property
    def elapsed(self) -> float:
        return sum(t.total for t in self.timers.values())

    def reads_per_sec(self) -> float:
        t = self.timers.get("total")
        return self.reads / t.total if t and t.total > 0 else 0.0

    def summary(self) -> dict:
        return {
            "reads": self.reads,
            "aligned": self.aligned,
            "aligned_pct": round(100.0 * self.aligned / max(1, self.reads), 2),
            "unique": self.unique,
            "proper_pairs": self.proper_pairs,
            "discordant": self.discordant,
            "locate_dropped": self.locate_dropped,
            "overflowed": self.overflowed,
            "escalated": self.escalated,
            "mapq_hist": dict(sorted(self.mapq_hist.items())),
            "reads_per_sec": round(self.reads_per_sec(), 1),
            "stage_seconds": {
                k: round(v.total, 4) for k, v in self.timers.items()
            },
        }

    def report(self, file=None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if file:
            print(s, file=file)
        return s

    def html(self, title="mapping report") -> str:
        """Standalone HTML run report (ref: stats.cpp HTML writer over
        basic/html.h: summary, MAPQ histogram, per-stage timing)."""
        from .html import page, table, bar_chart

        sm = self.summary()
        summary_rows = [
            (k, sm[k]) for k in ("reads", "aligned", "aligned_pct",
                                 "unique", "proper_pairs", "discordant",
                                 "reads_per_sec")
        ]
        sections = [
            ("Summary", table(summary_rows, header=("metric", "value"))),
            ("MAPQ histogram (aligned reads)", bar_chart(
                [(f"Q{k}-{k+9}", v) for k, v in sm["mapq_hist"].items()]
            )),
            ("Stage timing", bar_chart(
                list(sm["stage_seconds"].items()), unit=" s"
            )),
        ]
        return page(title, sections)
