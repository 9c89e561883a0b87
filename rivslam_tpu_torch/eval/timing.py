"""Per-stage timing (a copy of ``rivslam_tpu/eval/timing.py``, which has no
jax in it) — the structured replacement for the reference's ad-hoc
median-timing vectors dumped on `/command "time"` (preprocessing:1003-1022,
scan_matching:730-736, backend:1294-1315) and the declared-but-never-
implemented SimpleProfiler (rio_utils/simple_profiler.h)."""

from __future__ import annotations

import contextlib
import time

import numpy as np


class StageTimers:
    def __init__(self):
        self.samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.samples.setdefault(name, []).append(seconds)

    def summary(self) -> dict[str, dict]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": len(xs),
                "median_ms": float(np.median(a) * 1e3),
                "mean_ms": float(a.mean() * 1e3),
                "max_ms": float(a.max() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        """Markdown table, the SimpleProfiler's promised-but-absent output."""
        rows = ["| stage | count | median ms | mean ms | max ms |", "|---|---|---|---|---|"]
        for name, s in self.summary().items():
            rows.append(
                f"| {name} | {s['count']} | {s['median_ms']:.2f} "
                f"| {s['mean_ms']:.2f} | {s['max_ms']:.2f} |"
            )
        return "\n".join(rows)
