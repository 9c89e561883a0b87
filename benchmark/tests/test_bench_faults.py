"""The correctness check sees a broken timed path: runs of each cell on the
CPU, past the harness's look for a card, with a fault of
``benchmark/faults.py`` planted in the program, read ``correct`` false,
where the same run unbroken keeps the broken number under its limit.

Faults, as each cell can have them:
- a step that returns its state unchanged: the window backend keeps its
  state and gives the previous pose (stream); a registration returns its
  guess as its answer (both kinds); the global solve returns the graph it
  received (stream);
- a step cut short: a registration stops after one LM iteration, the
  global solve after one trust-region iteration;
- half of the batch left out, the mean taken over the rest (scan match);
- an answer altered where it is produced: REVE's ego velocity (stream),
  the registrations' poses, 1 cm off along x (scan match).
A cell runs on one card, so no exchange between cards can be left out. A
run on the CPU closes no loop in the few frames it can afford, so the
global solve's faults are shown on the check itself: a drifted ring with a
loop edge, solved by the program with the fault planted, handed to the
stream check as a window's solve.

    python -m pytest benchmark/tests/test_bench_faults.py -q -p no:cacheprovider
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import faults, harness, run  # noqa: E402
from benchmark.runners import stream  # noqa: E402
from benchmark.tests.test_bench_reference import _ring_graph  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**34 + 77
STREAM = dict(warmup_min_frames=3, warmup_until_loop=False, warmup_max_frames=3, max_frames_per_s=2,
              check_span=2, check_frames=2, trace_start=0, trace_frames=0)
SCAN = dict(batch=4, batches=1, check_span=1, check_batches=1, check_block=4)


def _run(workload: str, sizes: dict, fault: str | None = None) -> tuple[dict, dict]:
    torch.set_num_threads(4)
    seconds = 2.5 if workload.endswith("stream") else 1.0
    with faults.planted(fault):
        result, checks, _ = run.run_cell(workload, SEED, seconds, False, CPU, time.perf_counter(), sizes=sizes)
    return result, checks


@pytest.fixture(scope="module")
def sound():
    return {"cp.stream": _run("cp.stream", STREAM), "cp.scan_match": _run("cp.scan_match", SCAN)}


# a rehearsal checks fewer frames and pairs than a run's minimum, so these
# two fail at this size; no other number may
SAMPLE_SIZE = {"frames_checked", "pairs_checked"}


def _broken(result: dict, checks: dict, sound_checks: dict, name: str) -> None:
    assert not set(harness.judge(sound_checks)) - SAMPLE_SIZE, sound_checks
    assert name in harness.judge(checks), (name, checks[name])
    assert result["correct"] is False


@pytest.mark.parametrize("fault, workload, number", [
    ("backend_unchanged", "cp.stream", "backend_pose_gap_m"),
    ("ego_velocity_altered", "cp.stream", "ego_vel_gap_mps"),
    ("registration_returns_guess", "cp.stream", "reg_step_p50"),
    ("registration_one_iteration", "cp.stream", "reg_step_p50"),
    ("registration_returns_guess", "cp.scan_match", "reg_step_p50"),
    ("registration_one_iteration", "cp.scan_match", "reg_step_p50"),
    ("registration_half_batch", "cp.scan_match", "reg_error_gap_p75"),
    ("registration_moved", "cp.scan_match", "reg_error_gap_p75"),
])
def test_fault_fails_the_check(sound, fault, workload, number):
    result, checks = _run(workload, STREAM if workload.endswith("stream") else SCAN, fault)
    _broken(result, checks, sound[workload][1], number)


@pytest.mark.parametrize("fault", [None, "solve_unchanged", "solve_one_iteration"])
def test_global_solve_fault_fails_the_check(fault):
    """A window's global solve, by the program with ``fault`` planted, held
    by the stream check: sound, it passes; broken, ``solve_excess`` fails."""
    from rivslam_tpu_torch.loop import block_schur, global_graph

    cell = harness.load_cell("garden.stream")
    g = _ring_graph(global_graph, n=40, capacity=128)
    with faults.planted(fault):
        solved, chi2 = block_schur.solve_pose_graph_schur(g, num_blocks=32)
    kept = {"outputs": {}, "snaps": {}, "solves": [{"graph": g, "solved": solved, "chi2": chi2}]}
    gaps, _ = stream.check(cell, None, SEED, CPU, kept, {}, {**cell.traffic, "check_solves": 1})
    checks = harness.checks_of(gaps, cell.limits)
    assert (harness.judge(checks) == ["solve_excess"]) == (fault is not None), checks
    assert np.isfinite(gaps["solve_excess"])
