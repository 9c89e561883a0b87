"""The cp.vgicp and cp.replay cells on the CPU at a small size: their
traffic hands the program what the port's own helpers hand it, their
checks pass the program as it is, and each fault of
``benchmark/faults_voxel_replay.py`` (and the registration faults of
``benchmark/faults.py``) fails a limit:

- cp.vgicp: VGICP's voxel built as NDT's point spread
  (``voxel_cov_gap_p50``), its terms unweighted (``reg_error_gap_p75``), a
  registration returning its guess or stopping after one LM iteration
  (``reg_step_p50``);
- cp.replay: every frame's RANSAC draws shifted one frame (the floor's
  fit moves, and with it the window's chi2: ``backend_chi2_gap``; REVE
  refits its inliers, and its answer does not move), the registration
  returning its guess
  (``reg_step_p50``), the window backend leaving a frame out
  (``backend_pose_gap_m``).

    python -m pytest benchmark/tests/test_bench_voxel_replay.py -q -p no:cacheprovider
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

from benchmark import faults, faults_voxel_replay, harness, run  # noqa: E402,F401
from benchmark.runners import replay, scan_match  # noqa: E402
from rivslam_tpu_torch.io import datasets  # noqa: E402
from rivslam_tpu_torch.io import synthetic as port_synthetic  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**35 + 19
VOXEL = dict(batch=4, batches=1, check_span=1, check_batches=1, check_block=4)
REPLAY = dict(stretch=5, stretches=1, capacity=256, imu_capacity=32, check_span_calls=1, check_span=5,
              check_frames=3, backend_frames=4, trace_frames=2)
# at the cell's capacity, where the floor's RANSAC finds planes whose fit
# the draws move (REVE's refit on its inliers does not move)
REPLAY_FULL = dict(stretch=4, stretches=1, check_span_calls=1, check_span=4, check_frames=2, backend_frames=3,
                   trace_frames=2)
SIZES = {"cp.vgicp": VOXEL, "cp.replay": REPLAY, "cp.replay full": REPLAY_FULL}
# a rehearsal checks fewer frames and pairs than a run's minimum, so these
# two fail at this size; no other number may
SAMPLE_SIZE = {"frames_checked", "pairs_checked"}


def _run(case: str, fault: str | None = None) -> tuple[dict, dict]:
    """A run of ``case`` (a cell, at its size of ``SIZES``)."""
    torch.set_num_threads(4)
    with faults.planted(fault):
        result, checks, _ = run.run_cell(case.split()[0], SEED, 1.0, False, CPU, time.perf_counter(),
                                         sizes=SIZES[case])
    return result, checks


@pytest.fixture(scope="module")
def sound():
    return {case: _run(case) for case in SIZES}


def test_voxel_match_pairs_are_the_scan_matchs():
    """cp.vgicp registers the very pairs cp.scan_match registers."""
    a, b = (harness.load_cell(w) for w in ("cp.vgicp", "cp.scan_match"))
    shared = ("batch", "batches", "capacity", "recording_seed")
    assert {k: a.traffic[k] for k in shared} == {k: b.traffic[k] for k in shared}
    assert a.config["course"] == b.config["course"]
    small = {"batch": 3, "batches": 2, "capacity": 256}
    for x, y in zip(scan_match.make_batches(a.config, {**a.traffic, **small}),
                    scan_match.make_batches(b.config, {**b.traffic, **small})):
        for key in x:
            np.testing.assert_array_equal(x[key], y[key])


def test_replay_stretch_is_the_ports_stacked_sequence():
    """Stretch 0 is ``io.datasets.stack_sequence`` of the same course's
    first frames (the port's generator draws world and noise from one seed,
    so the course here does too); a later stretch's first IMU batch holds
    the samples since the frame before it, as a bag cut there carries
    them."""
    cell = harness.load_cell("cp.replay")
    tr = {**cell.traffic, "stretch": 3, "stretches": 2, "capacity": 256, "imu_capacity": 32}
    course_params = {k: v for k, v in cell.config["course"].items() if k != "world_seed"}
    course, stretches = replay.make_stretches({**cell.config, "course": course_params}, tr)
    seq, _ = port_synthetic.simulate_sequence(seed=tr["recording_seed"], n_frames=6, **course_params)
    want = datasets.stack_sequence(seq, 256, 32)
    for key, value in want.items():
        np.testing.assert_array_equal(stretches[0][key], value[:3], err_msg=key)
    dts, acc, _, m = course.imu_between(course.frames[2]["stamp"], course.frames[3]["stamp"], 32)
    np.testing.assert_array_equal(stretches[1]["imu_acc"][0], acc)
    np.testing.assert_array_equal(stretches[1]["imu_mask"][0], m)


@pytest.mark.parametrize("case", list(SIZES))
def test_check_passes_the_program(sound, case):
    result, checks = sound[case]
    assert not set(harness.judge(checks)) - SAMPLE_SIZE, checks
    assert all(np.isfinite(c["value"]) for c in checks.values())


@pytest.mark.parametrize("fault, case, number", [
    ("voxel_point_spread", "cp.vgicp", "voxel_cov_gap_p50"),
    ("voxel_unweighted", "cp.vgicp", "reg_error_gap_p75"),
    ("registration_returns_guess", "cp.vgicp", "reg_step_p50"),
    ("registration_one_iteration", "cp.vgicp", "reg_step_p50"),
    ("draws_shifted", "cp.replay full", "backend_chi2_gap"),
    ("registration_returns_guess", "cp.replay", "reg_step_p50"),
    ("backend_left_out", "cp.replay", "backend_pose_gap_m"),
])
def test_fault_fails_the_check(sound, fault, case, number):
    result, checks = _run(case, fault)
    assert not set(harness.judge(sound[case][1])) - SAMPLE_SIZE
    assert number in harness.judge(checks), (number, checks[number])
    assert result["correct"] is False
