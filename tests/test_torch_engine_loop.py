"""The port's Engine with the keyframe graph and loop closure, against the
JAX engine on the CPU, in float64, with the JAX engine's RANSAC draws
injected into the port (the ``uniforms`` seam).

The loop course is the "cp" validation course's world on a circle of radius
3 m at 2 m/s with 0.15 s frames: 0.3 m steps (off the 0.5 m keyframe gate)
and 0.1 rad a frame, so the course is back at its start after 63 of its 66
frames (a smaller circle turns the scan faster than the odometry follows at
256 points). The configuration is the "cp" preset with K1 on,
``floor_pts_thresh`` scaled to the 256-point capacity (as
tests/test_torch_engine.py), a window of 3 solved in at most 4 LM
iterations (the preset's 6 and 8 triple the port's CPU time, which its
host-bound window solve dominates), and the loop gates lowered for so
short a course, as tests/test_multiloop.py lowers them: accum distance 8 m,
loop interval 2 m, a yaw gate of 45 deg and a 0.15 drift ellipse (the
odometry drifts ~30 deg in yaw over this tight lap), scan-context distance
0.7; keyframe capacity 64 and 8 loop slots keep the block-Schur solve
small on the CPU. One loop closes, at frame 64.

Run as a script (``PYTHONPATH=. python tests/test_torch_engine_loop.py``),
it prints the JAX engine's figures on chip_smoke.py's two loop-closing
engine runs over the "cp" validation course (120 frames at capacity 1024,
float32 on the CPU, simulator seed 21): full-trajectory ATE (loop-corrected
and the window backend's own), keyframes and loops closed, for engine seeds
0, 1 and 2 of the preset run and seed 0 of the exact run. chip_smoke.py
holds the port's card runs to them.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared_cache import shared  # also: one torch thread per test process

from rivslam_tpu import pipeline as ref_pipeline
from rivslam_tpu import presets as ref_presets
from rivslam_tpu.eval import ate as ref_ate
from rivslam_tpu.io import datasets as ref_datasets
from rivslam_tpu.io import synthetic as ref_syn

from rivslam_tpu_torch import pipeline, presets
from rivslam_tpu_torch.io import datasets, synthetic

ENGINE_SEED = 0
IMU_CAP = 32
LOOP_COURSE = dict(seed=21, radius=3.0, omega=2.0 / 3.0, dt=0.15, n_frames=66, capacity=256,
                   world_points=20000, extent=30.0)
POSE_ATOL_F64 = 1e-4  # float64, a few frames: both engines run the same arithmetic
# float64 over the 66-frame loop course: the registration stops when a step
# is below 0.1 m and 2e-3 rad (the preset's launch values), so where the two
# packages' rounding puts a step on either side of that test, one takes one
# LM iteration more and the frame moves by up to that step; the keyframe
# chain then carries the offset. The RBF covariances of isolated points are
# rounding noise in float64 too, which is where such flips start. Measured:
# 3.4e-4 m at most (at frame 15, and from frame 43 on; below 3e-5 elsewhere).
LOOP_POSE_ATOL_F64 = 1e-3


def _loop_cfg(mod, capacity, **reg):
    cfg = mod.get("cp")
    return dataclasses.replace(
        cfg,
        floor=dataclasses.replace(cfg.floor, floor_pts_thresh=50 * capacity // 1024),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True, **reg),
        backend=dataclasses.replace(cfg.backend, window_size=3, max_solver_iterations=4),
        loop=dataclasses.replace(
            cfg.loop, accum_distance_thresh=8.0, min_loop_interval_dist=2.0,
            max_yaw_difference_deg=45.0, odom_drift_xy=0.15, sc_dist_thresh=0.7,
            keyframe_capacity=64, loop_capacity=8,
        ),
    )


def _draws(n_frames):
    """The JAX engine's per-frame key chain (pipeline.py:405), as a seam."""
    key, keys = jax.random.key(ENGINE_SEED), []
    for _ in range(n_frames):
        key, k1 = jax.random.split(key)
        keys.append(k1)
    return lambda frame_idx, shape: np.asarray(jax.random.uniform(keys[frame_idx], shape))


def _run_both(course, **reg):
    ref_seq, _ = ref_syn.simulate_sequence(**course)
    seq, _ = synthetic.simulate_sequence(**course)
    cap = course["capacity"]
    ref_eng = ref_pipeline.Engine(_loop_cfg(ref_presets, cap, **reg), dtype=jnp.float64, seed=ENGINE_SEED)
    ref = ref_datasets.replay(ref_eng, ref_seq, cap, IMU_CAP)
    eng = pipeline.Engine(_loop_cfg(presets, cap, **reg), dtype=torch.float64, seed=ENGINE_SEED,
                          device="cpu", uniforms=_draws(course["n_frames"]))
    return (ref_eng, ref), (eng, datasets.replay(eng, seq, cap, IMU_CAP))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _engine_view(eng, outs) -> dict:
    """What the tests read from a loop-closing engine run, in numpy and
    plain values (a fixture's result shared between test processes)."""
    g = eng.state.graph
    return dict(
        outs=[{"is_keyframe": bool(o["is_keyframe"]), "loop_found": bool(o["loop_found"]),
               "pose": _np(o["pose"]), "odom": _np(o["odom"])} for o in outs],
        loop_stats=dict(eng.loop_stats), kf_count=int(eng.state.kf_count),
        graph={name: _np(getattr(g, name)) for name in ("loop_mask", "loop_i", "loop_j")},
        kf_poses=eng.optimized_keyframe_poses(),
        trajectory={c: eng.trajectory(corrected=c) for c in (True, False)},
        timers=set(eng.timers.summary()),
    )


def _loop_views():
    (ref_eng, ref), (eng, got) = _run_both(LOOP_COURSE)
    return _engine_view(ref_eng, ref), _engine_view(eng, got)


@pytest.fixture(scope="module")
def loop_runs(request):
    return shared(request, "engine_loop_runs", _loop_views)


def _stack(outs, key):
    return np.stack([o[key] for o in outs])


def test_loop_engine_matches_reference(loop_runs):
    ref, got = loop_runs
    assert [o["is_keyframe"] for o in got["outs"]] == [o["is_keyframe"] for o in ref["outs"]]
    assert [o["loop_found"] for o in got["outs"]] == [o["loop_found"] for o in ref["outs"]]
    assert sum(o["loop_found"] for o in got["outs"]) >= 1
    assert got["loop_stats"] == ref["loop_stats"] and got["loop_stats"]["accepted"] >= 1
    for key in ("pose", "odom"):
        np.testing.assert_allclose(_stack(got["outs"], key), _stack(ref["outs"], key), rtol=0,
                                   atol=LOOP_POSE_ATOL_F64)


def test_loop_engine_graph_and_trajectories(loop_runs):
    ref, got = loop_runs
    assert got["kf_count"] == ref["kf_count"]
    for name in ("loop_mask", "loop_i", "loop_j"):
        np.testing.assert_array_equal(got["graph"][name], ref["graph"][name])
    np.testing.assert_allclose(got["kf_poses"], ref["kf_poses"], rtol=0, atol=LOOP_POSE_ATOL_F64)
    for corrected in (True, False):
        ts, poses = got["trajectory"][corrected]
        ref_ts, ref_poses = ref["trajectory"][corrected]
        np.testing.assert_array_equal(ts, ref_ts)
        np.testing.assert_allclose(poses, ref_poses, rtol=0, atol=LOOP_POSE_ATOL_F64)
    # the loop moved the corrected trajectory off the raw one
    assert np.abs(got["trajectory"][True][1] - got["trajectory"][False][1]).max() > 1e-3
    assert got["timers"] >= {"frame_step", "loop", "graph_opt"}


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_engine_configs_are_the_references():
    """chip_smoke.py's loop-on and exact engine runs use the configurations
    whose JAX figures it is held to; the exact one is the port's validation
    harness's (eval/validation.build_course_cfg), which builds the
    reference's."""
    from rivslam_tpu_torch.eval import validation

    cs = _chip_smoke()
    assert dataclasses.asdict(cs.preset_cfg(presets)) == dataclasses.asdict(preset_cfg(ref_presets))
    port_exact = validation.build_course_cfg("cp", reg_overrides={"use_fast_path": False})
    assert dataclasses.asdict(port_exact) == dataclasses.asdict(exact_cfg_reference())
    assert cs.exact_cfg() == port_exact


def preset_cfg(mod):
    """chip_smoke.py's loop-on run: the "cp" preset as shipped, with the
    fused correspondence kernel (K1) on."""
    cfg = mod.get("cp")
    return dataclasses.replace(
        cfg, registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True)
    )


def exact_cfg_reference():
    """chip_smoke.py's exact-path run, as the reference's validation harness
    builds it."""
    from rivslam_tpu.eval.validation import build_course_cfg

    return build_course_cfg("cp", reg_overrides={"use_fast_path": False})


def reference_course(cfg, seed: int = ENGINE_SEED) -> dict:
    """The JAX engine over the cp course under ``cfg``, engine seed ``seed``."""
    from rivslam_tpu.eval.validation import COURSES

    seq, _ = ref_syn.simulate_sequence(seed=21, **COURSES["cp"])
    eng = ref_pipeline.Engine(cfg, dtype=jnp.float32, seed=seed)
    outs = ref_datasets.replay(eng, seq, capacity=1024, imu_capacity=64)
    eng.finalize()
    gt = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses
    res = {"frames": len(outs), "keyframes": int(sum(o["is_keyframe"] for o in outs)),
           "loops": int(eng.loop_stats["accepted"]), "loop_stats": dict(eng.loop_stats)}
    for corrected in (True, False):
        ts, poses = eng.trajectory(corrected=corrected)
        g = gt[[int(np.argmin(np.abs(seq.gt_stamps - t))) for t in ts]]
        key = "full_ate_m" if corrected else "uncorrected_ate_m"
        res[key] = ref_ate.ate(poses[:, :3, 3], g[:, :3, 3])["rmse"]
    return res


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for seed in (0, 1, 2):
        print(json.dumps({"preset": reference_course(preset_cfg(ref_presets), seed), "seed": seed}),
              flush=True)
    print(json.dumps({"exact": reference_course(exact_cfg_reference()), "seed": ENGINE_SEED}), flush=True)
