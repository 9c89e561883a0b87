"""The port's harnesses and offline tools on the CPU: ``tools.py``
(``adjust_trajectory``, ``associate_by_stamp``, ``align_gps_trajectory``)
against the JAX package's, the validation harness's ``run_course`` on a
cut course, and the latency harness (``python -m
rivslam_tpu_torch.eval.latency``) at a few frames.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

from rivslam_tpu import tools as ref_tools
from rivslam_tpu.core import lie as ref_lie
from rivslam_tpu_torch import tools
from rivslam_tpu_torch.eval import latency, validation


def _trajectory(n=20, seed=0):
    """A noisy planar loop of n poses (float64)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / n
        xi = np.array([0.0, 0.0, th + 0.02 * rng.normal(), 5 * np.cos(th), 5 * np.sin(th), 0.05 * rng.normal()])
        poses.append(np.asarray(ref_lie.se3_exp(jnp.asarray(xi))))
    return np.stack(poses)


def test_adjust_trajectory_matches_reference():
    """A chain of 20 poses with two manual loop edges, float64: within 1e-6 m
    of the reference's optimized trajectory (both solve by Gauss-Newton
    with the same CG)."""
    poses = _trajectory()
    loops = [(0, 19, np.linalg.inv(poses[0]) @ poses[19]), (3, 15, np.eye(4))]
    ref = ref_tools.adjust_trajectory(poses, loops)
    got = tools.adjust_trajectory(poses, loops)
    assert got.shape == ref.shape == (20, 4, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.abs(got - poses).max() > 1e-3  # the loop edge moved the chain


def test_align_gps_trajectory_matches_reference():
    """Stamp association and the UTM -> world alignment: the same pairs, R
    and t to float64 rounding; fewer than 3 pairs raise."""
    rng = np.random.default_rng(1)
    ts = np.arange(50) * 0.1
    pos = np.cumsum(rng.normal(size=(50, 3)), axis=0)
    yaw = 0.7
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    gps_ts = ts[::3] + 0.01
    utm = (pos[::3] - [10.0, 20.0, 1.0]) @ R  # world = R utm + t
    got = tools.align_gps_trajectory(ts, pos, gps_ts, utm)
    ref = ref_tools.align_gps_trajectory(ts, pos, gps_ts, utm)
    assert got[2] == ref[2] == tools.associate_by_stamp(ts, gps_ts) == ref_tools.associate_by_stamp(ts, gps_ts)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[0], R, atol=1e-9)
    with pytest.raises(ValueError, match="associations"):
        tools.align_gps_trajectory(ts, pos, gps_ts[:2], utm[:2])


def test_run_course_scores_a_cut_course():
    """run_course simulates, replays and scores a course: the cp course cut
    to 3 frames at capacity 256, loop closure off."""
    res = validation.run_course("cp", loop_on=False, sim_overrides={"n_frames": 3, "capacity": 256},
                                device="cpu")
    assert res["frames"] == 3 and res["loops_closed"] == 0 and res["covariance_method"] == "RBF"
    for k in ("odom_kf_ate_m", "opt_kf_ate_m", "full_ate_m", "re_trans_rmse_m", "re_rot_rmse_deg"):
        assert np.isfinite(res[k]) and res[k] < 5.0, (k, res[k])


def test_latency_harness_runs_on_the_cpu(tmp_path, capsys):
    """The latency harness's replay timing and its fleet at B=2, 3 frames at
    capacity 128; the JSON holds the reference's keys."""
    out = tmp_path / "lat.json"
    assert latency.main(["--frames", "3", "--capacity", "128", "--imu-capacity", "16", "--repeats", "1",
                         "--fleet", "2", "--cpu", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["frames"] == 3
    for k in ("ms_per_frame", "frames_per_s", "real_time_factor_10hz", "mean_solver_iterations"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert res["fleet"]["fleet_B"] == 2 and res["fleet"]["aggregate_frames_per_s"] > 0
    assert '"fleet_B": 2' in capsys.readouterr().out
