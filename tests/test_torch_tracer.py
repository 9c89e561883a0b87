"""The port's tracer (``rivslam_tpu_torch/eval/timing.StageTimers``): off it
keeps nothing, on it keeps each span's record, each frame's per-stage host
time and the counters, on the clock ``torch.profiler`` puts its events on.

The CUDA case (one host read counts one host sync) runs on the card only:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tracer.py
"""

import gc
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from rivslam_tpu_torch import pipeline, presets
from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.eval.timing import StageTimers
from rivslam_tpu_torch.io import datasets, synthetic
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)


@pytest.fixture
def tracer():
    t = StageTimers().on()
    try:
        yield t
    finally:
        t.off()


def _sync_mode():
    return torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else None


def _busy(seconds: float = 2e-3) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def _instrument(t: StageTimers, use: str) -> None:
    if use == "span":
        with t.span("a"), t.span("b"):
            _busy()
    elif use == "sample span":
        with t.span("a", sample="stage"):
            _busy()
    elif use == "frame":
        with t.frame(0), t.span("a"):
            _busy()
    elif use == "count":
        t.count("host_syncs")
        timing.count("graph_replays", "g")
    elif use == "module span":
        with timing.span("a"):
            timing.count("lm_iterations", n=3)
    elif use == "on then off":
        t.on().off()


@pytest.mark.parametrize("use", ["span", "sample span", "frame", "count", "module span", "on then off"])
def test_off_keeps_nothing_and_restores(use):
    shown, filters, mode = warnings.showwarning, list(warnings.filters), _sync_mode()
    t = StageTimers()
    _instrument(t, use)
    assert not t.is_on and timing._active is None
    assert t.records() == [] and t.frames() == []
    assert all(v == {} for v in t.totals().values())
    assert list(t.samples) == (["stage"] if use == "sample span" else [])
    assert warnings.showwarning is shown and warnings.filters == filters and _sync_mode() == mode
    assert t.report() == t.report().split("\n\n")[0]  # no per-stage table


@pytest.mark.parametrize("nest", [("a",), ("a", "b"), ("a", "b", "c")])
def test_nested_spans_attribute_to_the_innermost(tracer, nest):
    with tracer.frame(7):
        for _ in range(2):
            with tracer.span(nest[0]):
                _busy()
                if len(nest) > 1:
                    with tracer.span(nest[1]):
                        tracer.count("host_syncs")
                        if len(nest) > 2:
                            with tracer.span(nest[2]):
                                tracer.count("host_syncs", n=2)
                                _busy()
        tracer.count("host_syncs")
    tracer.count("host_syncs")
    (f,) = tracer.frames()
    recs = tracer.records()
    assert {r[0] for r in recs} == set(nest) | {timing.FRAME_SPAN}
    assert all(r[4] == 7 for r in recs)
    # a frame's stage sums are its spans' host times
    for name in nest:
        mine = [(e - s) / 1e6 for n, s, e, *_ in recs if n == name]
        assert f["calls"][name] == len(mine) == 2
        assert f["stages"][name] == pytest.approx(sum(mine), rel=1e-12)
    assert list(f["top_level"]) == [nest[0]]
    assert f["unspanned_ms"] == pytest.approx(f["ms"] - f["stages"][nest[0]])
    assert f["ms"] >= f["stages"][nest[0]] > 0
    # counts under the innermost span open, in the frame and in total
    want = {timing.FRAME_SPAN: 1}
    if len(nest) > 1:
        want[nest[1]] = 2
    if len(nest) > 2:
        want[nest[2]] = 4
    assert f["counters"]["host_syncs"] == want
    assert tracer.totals()["host_syncs"] == {**want, timing.OUTSIDE: 1}
    table = tracer.stage_table()
    assert f"| {nest[0]} | top |" in table and table.count("| top |") == 2


@pytest.mark.parametrize("counter", timing.COUNTERS)
def test_counters_add_per_frame_and_in_total(tracer, counter):
    tracer.count(counter, "k", 5)  # before any frame: in the total only
    for i in range(3):
        with tracer.frame(i):
            for _ in range(i + 1):
                timing.count(counter, "k")
            worker = threading.Thread(target=lambda: timing.count(counter, "w", 10))
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
    assert [f["counters"][counter] for f in tracer.frames()] == [{"k": i + 1, "w": 10} for i in range(3)]
    assert tracer.totals()[counter] == {"k": 5 + 1 + 2 + 3, "w": 30}
    assert all(v == {} for c, v in tracer.totals().items() if c != counter)


def test_worker_thread_spans_go_beside_the_frame(tracer):
    def work():
        with timing.span("worker.job"):
            _busy()
            timing.count("host_syncs")

    with tracer.frame(0):
        with tracer.span("a"):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=10)
    (f,) = tracer.frames()
    assert "worker.job" not in f["stages"] and f["other_threads"]["worker.job"] > 0
    assert f["counters"]["host_syncs"] == {"worker.job": 1}
    (rec,) = [r for r in tracer.records() if r[0] == "worker.job"]
    assert rec[3] != threading.get_ident() and rec[4] == 0 and rec[5] == 0


def test_a_second_tracer_is_refused(tracer):
    with pytest.raises(RuntimeError, match="another tracer"):
        StageTimers().on()


@pytest.mark.parametrize("nest", [("p",), ("p", "q")])
def test_records_on_the_profilers_clock(tracer, nest):
    """Each span's record and the profiler's event of its name agree within
    100 us at both ends; one span in ten may straddle a moment the host
    thread was descheduled (seen under a loaded CPU), which no clock fixes."""
    reps = 10
    with timing.span("warm"):  # the first record_function of a process is slow to open
        pass
    gc.disable()  # a collection inside a span's edge would be a host stall, not a clock gap
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with timing.span("warm"):
                pass
            for _ in range(reps):
                with timing.span(nest[0]):
                    torch.ones(64).sum()
                    _busy(2e-4)
                    if len(nest) > 1:
                        with timing.span(nest[1]):
                            _busy(2e-4)
    finally:
        gc.enable()
    events = {}
    for e in prof.events():
        if e.name in nest:
            events.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    spans = {}
    for name, s, e, *_ in tracer.profiler_spans(prof):
        if name in nest:
            spans.setdefault(name, []).append((s, e))
    for name in nest:
        got, want = np.asarray(sorted(spans[name])), np.asarray(sorted(events[name]))
        assert got.shape == want.shape == (reps, 2)
        gap = np.abs(got - want).max(axis=1)  # microseconds, the larger of the two ends
        assert np.sum(gap >= 100.0) <= 1, gap


def test_engine_frames_keep_the_samples(tracer):
    seq, _ = synthetic.simulate_sequence(seed=21, radius=8.0, omega=0.25, n_frames=3, capacity=256)
    eng = pipeline.Engine(presets.get("cp"), device="cpu", timers=tracer)
    datasets.replay(eng, seq, capacity=256, imu_capacity=32)
    frames = tracer.frames()
    assert [f["index"] for f in frames] == [0, 1, 2]
    assert set(eng.timers.samples) >= {"frame_step", "loop"}
    assert len(eng.timers.samples["frame_step"]) == 3
    assert len(eng.timers.samples["loop"]) == sum("engine.keyframe" in f["stages"] for f in frames)
    stages = ("engine.preprocess", "engine.backend", "preprocess.reve", "preprocess.floor", "apdgicp.prepare",
              "backend.window_solve")
    for f in frames:
        assert all(f["stages"][s] > 0 for s in stages)
        assert sum(f["top_level"].values()) + f["unspanned_ms"] == pytest.approx(f["ms"])
        assert f["unspanned_ms"] < 0.2 * f["ms"]
    assert "engine.odometry" not in frames[0]["stages"] and "engine.odometry" in frames[1]["stages"]
    assert sum(frames[1]["counters"]["lm_iterations"].values()) >= 1
    assert "| engine.process_frame | frame |" in eng.timers.report()


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op, syncs", [("item", 1), ("bool", 1), ("cpu", 1), ("add", 0)])
def test_one_host_read_counts_one_sync(cuda_dev, op, syncs):
    x = torch.arange(4.0, device=cuda_dev)
    mode = torch.cuda.get_sync_debug_mode()
    t = StageTimers().on()
    try:
        with t.frame(0), t.span("read"):
            if op == "item":
                x.sum().item()
            elif op == "bool":
                bool(x.sum() > 0)
            elif op == "cpu":
                x.cpu()
            else:
                x.add_(1.0)
    finally:
        t.off()
    assert t.frames()[0]["counters"]["host_syncs"] == ({"read": syncs} if syncs else {})
    assert torch.cuda.get_sync_debug_mode() == mode
