"""Per-stage timing and the port's tracer.

``StageTimers`` (the Engine's ``timers``) began as a copy of
``rivslam_tpu/eval/timing.py``, the structured replacement for the
reference's ad-hoc median-timing vectors dumped on `/command "time"`
(preprocessing:1003-1022, scan_matching:730-736, backend:1294-1315) and the
declared-but-never-implemented SimpleProfiler (rio_utils/simple_profiler.h).
``samples``, ``time``, ``add``, ``summary`` and ``report`` keep that copy's
behaviour: host-clock samples by key, always on.

It is also the port's one tracer. ``span(name)`` marks a region: it opens
``torch.profiler.record_function(name)`` while a profiler records, so a
profiler's trace names every region, and with ``sample`` it adds the
region's host seconds to ``samples[sample]``, always. Code below the Engine
(the backend, the solvers, the registration, the CUDA graphs) marks its
regions with the module-level ``span`` and ``count``, which go to the
tracer that is on. Off, the default, a span costs two flag tests (is a
profiler recording, is a tracer on) and keeps nothing.

Switched on (``on()``; at most one tracer a process, since the CUDA sync
debug mode it sets is process-wide), the tracer keeps:

- a record of every span of every thread: (name, start ns, end ns, thread,
  frame index, depth), start and end in Unix-epoch nanoseconds
  (``time.time_ns``), the clock ``torch.profiler`` puts its events on;
  ``profiler_spans`` converts them onto a profiler's timeline;
- a record of each frame (``frame``, one a ``process_frame``): its host ms,
  the host ms and calls of each span of the frame's thread (``stages``, and
  ``top_level`` for the spans directly inside the frame), the ms outside
  those (``unspanned_ms``), other threads' spans during the frame, and the
  counters' increments (``frames()``);
- counters, per frame and in total since ``on`` (``totals()``):
  ``host_syncs`` by the innermost span open on the syncing thread: every
  synchronizing CUDA call that ``torch.cuda.set_sync_debug_mode("warn")``
  reports (``.item()``, ``bool``/``float`` of a device tensor, a copy to
  the host, ``nonzero``, ``bincount``, a synchronize), its warning counted
  and not shown; ``graph_captures``, ``graph_capture_ms`` (host ms of
  warm-up and capture, which run inside a ``graph.capture`` span) and
  ``graph_replays``, by CUDA graph (``core/cuda_graph.Graphed``);
  ``lm_iterations``, outer iterations of the registration's LM, eager
  (``apdgicp.solve_lm``) or replayed (``apdgicp.GraphedRegistration``), and
  of the window solve (``solver/window.solve``),
  and ``lm_tries``, the window solve's lambda tries, by the span open
  around the call; ``voxel_maps``, the VGICP / NDT voxel maps built
  (``apdgicp.register_dispatch``, one a problem); ``registrations_graphed``
  and ``registrations_eager``, one a registration (``apdgicp.run_registration``,
  which ``register_dispatch`` reaches for every method) by the path it took,
  CUDA-graph replays or eager, by the span open around the call: their
  ratio is how often the registration's graphs engage.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import warnings

import numpy as np
import torch
from torch.profiler import record_function

SYNC_WARNING = "called a synchronizing CUDA operation"  # torch's sync debug warning
OUTSIDE = "(outside any span)"  # a counter's key where no span is open
COUNTERS = ("host_syncs", "graph_captures", "graph_capture_ms", "graph_replays", "lm_iterations", "lm_tries",
            "voxel_maps", "registrations_graphed", "registrations_eager")
FRAME_SPAN = "engine.process_frame"
CAPTURE_SPAN = "graph.capture"
# records kept while on, the oldest dropped first: about two hours of the
# cp preset's frames at 4 Hz
MAX_RECORDS = 2_000_000
MAX_FRAMES = 100_000

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_active: StageTimers | None = None  # the tracer that is on


def _scope(name: str):
    """``record_function(name)`` while a profiler records, else nothing."""
    return record_function(name) if _profiling() else _NULL


def span(name: str):
    """A region of the program: the span of the tracer that is on, else
    ``record_function(name)`` while a profiler records."""
    tracer = _active
    return _scope(name) if tracer is None else tracer.span(name)


def count(counter: str, key: str | None = None, n: int = 1) -> None:
    """Add n to ``counter`` of the tracer that is on (``key`` None: by the
    innermost span open on this thread)."""
    tracer = _active
    if tracer is not None:
        tracer.count(counter, key, n)


class StageTimers:
    def __init__(self):
        self.samples: dict[str, list[float]] = {}
        self._on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
        self._frames: collections.deque = collections.deque(maxlen=MAX_FRAMES)
        self._totals: dict[str, dict] = {c: {} for c in COUNTERS}
        self._frame: dict | None = None
        self._restore = None

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
        """Markdown table, the SimpleProfiler's promised-but-absent output;
        after it, while the tracer holds frames, their per-stage table."""
        rows = ["| stage | count | median ms | mean ms | max ms |", "|---|---|---|---|---|"]
        for name, s in self.summary().items():
            rows.append(
                f"| {name} | {s['count']} | {s['median_ms']:.2f} "
                f"| {s['mean_ms']:.2f} | {s['max_ms']:.2f} |"
            )
        table = "\n".join(rows)
        return f"{table}\n\n{self.stage_table()}" if self._frames else table

    # ---- the tracer ---------------------------------------------------------

    @property
    def is_on(self) -> bool:
        return self._on

    def on(self) -> StageTimers:
        """Start tracing with empty records and counters. On a CUDA host the
        sync debug mode is set to warn, and its warnings are counted as
        host syncs instead of shown, until ``off``."""
        global _active
        if _active is not None and _active is not self:
            raise RuntimeError("another tracer is on in this process")
        if self._on:
            return self
        self._records.clear()
        self._frames.clear()
        self._totals = {c: {} for c in COUNTERS}
        self._local = threading.local()
        if torch.cuda.is_available():
            mode, show = torch.cuda.get_sync_debug_mode(), warnings.showwarning
            warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
            self._restore = (mode, show, warnings.filters[0])
            warnings.showwarning = self._on_warning
            torch.cuda.set_sync_debug_mode("warn")
        _active, self._on = self, True
        return self

    def off(self) -> StageTimers:
        """Stop tracing; the records, frames and totals stay readable, and
        the sync debug mode and the warning display are as ``on`` found them."""
        global _active
        if not self._on:
            return self
        self._on = False
        if _active is self:
            _active = None
        if self._restore is not None:
            mode, show, flt = self._restore
            self._restore = None
            torch.cuda.set_sync_debug_mode(mode)
            if warnings.showwarning == self._on_warning:
                warnings.showwarning = show
            if flt in warnings.filters:
                warnings.filters.remove(flt)
                warnings._filters_mutated()
        return self

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            self.count("host_syncs")
        elif self._restore is not None:
            self._restore[1](message, category, filename, lineno, file, line)

    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def innermost(self) -> str:
        """The innermost span open on this thread."""
        stack = self._stack()
        return stack[-1] if stack else OUTSIDE

    def span(self, name: str, sample: str | None = None):
        """A region named ``name`` (see the module's docstring); with
        ``sample``, its host seconds also go to ``samples[sample]``."""
        if not self._on and sample is None:
            return _scope(name)
        return self._span(name, sample)

    @contextlib.contextmanager
    def _span(self, name: str, sample: str | None):
        # the record's start and end are read right inside the profiler's
        # scope, and its bookkeeping happens outside it, so that the two
        # agree on the profiler's clock
        t0 = time.perf_counter()
        stack, ns0, ns1 = None, 0, 0
        try:
            with _scope(name):
                ns0 = time.time_ns()
                if self._on:
                    stack = self._stack()
                    stack.append(name)
                try:
                    yield
                finally:
                    ns1 = time.time_ns()
        finally:
            if stack is not None:
                stack.pop()
                self._close(name, len(stack), ns0, ns1)
            if sample is not None:
                self.add(sample, time.perf_counter() - t0)

    def _close(self, name: str, depth: int, ns0: int, ns1: int) -> None:
        thread = threading.get_ident()
        f = self._frame
        self._records.append((name, ns0, ns1, thread, None if f is None else f["index"], depth))
        if f is None:
            return
        ms = (ns1 - ns0) / 1e6
        if thread != f["thread"]:
            with self._lock:
                _add(f["other_threads"], name, ms)
        elif depth > f["depth"]:
            _add(f["stages"], name, ms)
            _add(f["calls"], name, 1)
            if depth == f["depth"] + 1:
                _add(f["top_level"], name, ms)

    def count(self, counter: str, key: str | None = None, n: int = 1) -> None:
        """While on, add n to ``counter`` under ``key`` (None: the innermost
        span open on this thread), in total and in the current frame."""
        if not self._on:
            return
        if key is None:
            key = self.innermost()
        with self._lock:
            _add(self._totals[counter], key, n)
            f = self._frame
            if f is not None:
                _add(f["counters"][counter], key, n)

    def frame(self, index: int):
        """One frame of the Engine (``process_frame``): a span named
        ``FRAME_SPAN`` and, while on, the frame's record."""
        if not self._on:
            return _scope(FRAME_SPAN)
        return self._framed(index)

    @contextlib.contextmanager
    def _framed(self, index: int):
        f = {"index": index, "thread": threading.get_ident(), "depth": len(self._stack()),
             "stages": {}, "calls": {}, "top_level": {}, "other_threads": {},
             "counters": {c: {} for c in COUNTERS}}
        self._frame = f
        f["start_ns"] = time.time_ns()
        try:
            with self._span(FRAME_SPAN, None):
                yield
        finally:
            f["end_ns"] = time.time_ns()
            self._frame = None
            f["ms"] = (f["end_ns"] - f["start_ns"]) / 1e6
            f["unspanned_ms"] = f["ms"] - sum(f["top_level"].values())
            del f["depth"]
            self._frames.append(f)

    def frames(self) -> list[dict]:
        """The frame records kept since ``on``, oldest first."""
        return list(self._frames)

    def totals(self) -> dict[str, dict]:
        """Each counter by key, since ``on``."""
        with self._lock:
            return {c: dict(v) for c, v in self._totals.items()}

    def records(self) -> list[tuple]:
        """The span records since ``on``: (name, start ns, end ns, thread,
        frame index or None, depth), Unix-epoch nanoseconds."""
        return list(self._records)

    def profiler_spans(self, prof) -> list[tuple]:
        """The span records on the timeline of ``prof`` (a finished
        ``torch.profiler.profile``): start and end in microseconds since its
        trace started, as ``prof.events()``' ``time_range``."""
        base = prof.profiler.kineto_results.trace_start_ns()
        return [(n, (s - base) / 1e3, (e - base) / 1e3, *rest) for n, s, e, *rest in self._records]

    def stage_table(self, frames: list[dict] | None = None) -> str:
        """Markdown: each span's host ms, calls and host syncs (counted
        under the innermost span) a frame; the ``top`` rows, the frame's
        top-level spans and the time outside them, add up to the frame.
        Then the graph captures, replays, LM iterations, lambda tries,
        voxel maps and registrations (graphed / eager) of those frames."""
        frames = self.frames() if frames is None else frames
        if not frames:
            return ""
        n = len(frames)

        def per_frame(key: str) -> dict:
            out: dict = {}
            for f in frames:
                for k, v in f[key].items():
                    _add(out, k, v / n)
            return out

        def counter(name: str) -> dict:
            out: dict = {}
            for f in frames:
                for k, v in f["counters"][name].items():
                    _add(out, k, v)
            return out

        ms, calls, top, syncs = per_frame("stages"), per_frame("calls"), per_frame("top_level"), counter("host_syncs")
        rows = [f"| span ({n} frames) | level | ms a frame | calls a frame | host syncs a frame |",
                "|---|---|---|---|---|",
                f"| {FRAME_SPAN} | frame | {np.mean([f['ms'] for f in frames]):.3f} | 1 | {sum(syncs.values()) / n:.2f} |"]
        order = sorted(top, key=lambda k: -top[k]) + sorted(set(ms) - set(top), key=lambda k: -ms[k])
        for name in order:
            level = "top" if name in top else "inner"
            rows.append(f"| {name} | {level} | {ms[name]:.3f} | {calls[name]:.2f} | {syncs.get(name, 0) / n:.2f} |")
        rows.append(f"| (outside the top-level spans) | top | {np.mean([f['unspanned_ms'] for f in frames]):.3f} "
                    f"| | {syncs.get(FRAME_SPAN, 0) / n:.2f} |")
        caps, cap_ms = counter("graph_captures"), counter("graph_capture_ms")
        replays, lm, tries = counter("graph_replays"), counter("lm_iterations"), counter("lm_tries")
        lines = [
            "",
            f"graph captures in these frames: {sum(caps.values())}"
            + (f" ({', '.join(f'{k}: {v}, {cap_ms[k]:.1f} ms' for k, v in sorted(caps.items()))})" if caps else ""),
            f"graph replays a frame: {sum(replays.values()) / n:.2f}",
            f"LM iterations a frame: {sum(lm.values()) / n:.2f}"
            + (f" ({', '.join(f'{k}: {v / n:.2f}' for k, v in sorted(lm.items()))})" if lm else ""),
            f"window-solve lambda tries a frame: {sum(tries.values()) / n:.2f}",
            f"voxel maps a frame: {sum(counter('voxel_maps').values()) / n:.2f}",
            "registrations a frame, graphed / eager: "
            f"{sum(counter('registrations_graphed').values()) / n:.2f} / "
            f"{sum(counter('registrations_eager').values()) / n:.2f}",
        ]
        return "\n".join(rows + lines)


def _add(d: dict, key, value) -> None:
    d[key] = d.get(key, 0) + value
