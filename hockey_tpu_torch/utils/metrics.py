"""Structured per-stage metrics (the reference only has print() + tqdm —
SURVEY.md §5 observability gap)."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

from .profiling import annotate


class StageTimers:
    """Wall-clock accumulators per pipeline stage + frame counters. Each
    stage is also an `annotate` range of its name, so a profiler trace
    shows the stages beside the device's work."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}  # last-value metrics

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.counters.clear()
        self.gauges.clear()

    def summary(self) -> Dict:
        out = {}
        for name, total in self.totals.items():
            n = max(self.counts[name], 1)
            out[name] = {"total_s": round(total, 4), "calls": self.counts[name],
                         "mean_ms": round(total / n * 1000, 3)}
        out["counters"] = dict(self.counters)
        if self.gauges:
            out["gauges"] = dict(self.gauges)
        return out

    def dump_json(self, path: Optional[str], **extra) -> None:
        """`summary()`, with the `extra` entries beside it, as JSON."""
        if path:
            with open(path, "w") as f:
                json.dump(dict(self.summary(), **extra), f, indent=2)
