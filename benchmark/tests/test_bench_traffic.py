"""The benchmark's frozen course generator gives the port's generator's
courses, frame by frame, and hands a frame over as the port's replay does.

    python -m pytest benchmark/tests/test_bench_traffic.py -q -p no:cacheprovider
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.traffic import synthetic  # noqa: E402
from rivslam_tpu_torch.core.pointcloud import RadarCloud  # noqa: E402
from rivslam_tpu_torch.eval import validation  # noqa: E402
from rivslam_tpu_torch.io import synthetic as port_synthetic  # noqa: E402

CAPACITY, IMU_CAPACITY = 256, 32


def _courses(name: str, seed: int, n_frames: int):
    params = dict(validation.COURSES[name], n_frames=n_frames)
    seq, _ = port_synthetic.simulate_sequence(seed=seed, **params)
    return seq, synthetic.simulate_sequence(seed=seed, **params)


@pytest.mark.parametrize("name,seed", [("cp", 0), ("garden", 2**33 + 5)])
def test_course_equals_the_ports(name, seed):
    seq, course = _courses(name, seed, 6)
    assert course.num_frames == seq.num_frames
    for i in range(seq.num_frames):
        f = seq.frame(i)
        g = course.frames[i]
        assert g["stamp"] == f["stamp"]
        for key in ("xyz", "doppler", "intensity"):
            np.testing.assert_array_equal(g[key], f[key])
    np.testing.assert_array_equal(course.imu_stamps, seq.imu_stamps)
    np.testing.assert_array_equal(course.imu_acc, seq.imu_acc)
    np.testing.assert_array_equal(course.imu_gyr, seq.imu_gyr)
    np.testing.assert_array_equal(course.gt_poses, seq.gt_poses)
    np.testing.assert_array_equal(course.baro_alt, seq.baro_alt)


def test_hand_over_equals_the_ports_replay():
    """The padded cloud, the IMU batch and the barometer reading of each
    frame are those that ``io.datasets.replay`` hands the engine."""
    seq, course = _courses("cp", 3, 4)
    prev_t = None
    for i in range(seq.num_frames):
        f = seq.frame(i)
        cloud = RadarCloud.from_numpy(f["xyz"], CAPACITY, doppler=f["doppler"], intensity=f["intensity"],
                                      dtype=torch.float64, device="cpu")
        xyz, dop, inten, mask = course.padded(i, CAPACITY)
        np.testing.assert_array_equal(xyz, cloud.xyz.numpy())
        np.testing.assert_array_equal(dop, cloud.doppler.numpy())
        np.testing.assert_array_equal(inten, cloud.intensity.numpy())
        np.testing.assert_array_equal(mask, cloud.mask.numpy())
        t0 = prev_t if prev_t is not None else f["stamp"] - 0.1
        for a, b in zip(course.imu_for_frame(i, IMU_CAPACITY), seq.imu_between(t0, f["stamp"], IMU_CAPACITY)):
            np.testing.assert_array_equal(a, b)
        assert course.baro_at(f["stamp"]) == seq.baro_at(f["stamp"])
        prev_t = f["stamp"]


def test_world_seed_fixes_the_scene_and_seed_draws_the_noise():
    params = dict(validation.COURSES["cp"], n_frames=3)
    a = synthetic.simulate_sequence(seed=1, world_seed=21, **params)
    b = synthetic.simulate_sequence(seed=2, world_seed=21, **params)
    c = synthetic.simulate_sequence(seed=1, world_seed=21, **params)
    np.testing.assert_array_equal(a.frames[0]["xyz"], c.frames[0]["xyz"])
    assert not np.array_equal(a.frames[0]["xyz"], b.frames[0]["xyz"])
    # the same scene: the noiseless truth is seed-free, and the measured
    # points of one scene lie within the noise of each other's
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    near = np.abs(np.sort(np.linalg.norm(a.frames[0]["xyz"], axis=1))[:200]
                  - np.sort(np.linalg.norm(b.frames[0]["xyz"], axis=1))[:200])
    assert np.median(near) < 0.1
