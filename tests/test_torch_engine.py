"""The port's per-frame engine against the JAX engine on the CPU.

One short synthetic course runs through both Engines with the same seed and
the JAX engine's own RANSAC draws injected into the port (the ``uniforms``
seam), in float64 and in float32, frame by frame. Also: the simulator, the
sequence container, replay and ATE copies, the parts of the reference
Engine that earlier slices left out (they now run), and the GPS and
barometer priors of the keyframe graph.

Run as a script (``PYTHONPATH=. python tests/test_torch_engine.py``), it
prints the JAX engine's full-trajectory ATE on chip_smoke.py's engine course
(the "cp" validation course, 120 frames at capacity 1024, the slice's
configuration, float32 on the CPU): the reference chip_smoke.py holds the
port's card run to.

The course is the "cp" validation course's world and circle with the frame
interval cut to 0.15 s, 6 frames at capacity 256 and IMU capacity 32. The
configuration is the slice's (the "cp" preset, loop closure off, K1 on),
with ``floor_pts_thresh`` scaled with the capacity (50 * 256/1024 -> 12):
at 256 points the preset's 50 inliers are out of reach, the floor is never
found, and the fallback plane then strips all but a handful of points. The
0.3 m frame steps keep the keyframe gate (0.5 m) 0.1-0.2 m from either
side; the cp course's own 0.5 m steps sit exactly on it.
"""

import dataclasses
import json

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
from rivslam_tpu_torch.eval import ate
from rivslam_tpu_torch.io import datasets, synthetic

COURSE = dict(seed=21, radius=8.0, omega=0.25, dt=0.15, n_frames=6, capacity=256,
              world_points=20000, extent=30.0)
CAP, IMU_CAP, ENGINE_SEED = 256, 32, 0
# float64: both engines run the same arithmetic; measured gap 7.4e-6 m
POSE_ATOL_F64 = 1e-4
# float32: the reference's own float32 run departs from its float64 run by
# up to 0.16 m in position and 290 in chi2 (of ~1500) on this course: RBF
# covariances of isolated points are rounding noise in float32, and the
# window LM stops at a looser tolerance. The port is held to that band:
# within 0.25 m of the reference's float32 poses, and no further from the
# float64 run, in poses and in chi2, than twice the reference's own float32
# departure (plus 1 cm / 1% of the largest chi2).
POSE_ATOL_F32 = 0.25


def _cfg(mod):
    cfg = mod.get("cp")
    return dataclasses.replace(
        cfg,
        loop=dataclasses.replace(cfg.loop, enable=False),
        floor=dataclasses.replace(cfg.floor, floor_pts_thresh=12),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )


def _host(x):
    """x with every array (JAX, torch) as a numpy array, through dicts,
    lists and tuples."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def _engine_view(eng, outs):
    """(what the tests read from the engine, the per-frame outputs), in numpy
    and plain values: the fixture's result is shared between test
    processes."""
    st = eng.state
    view = dict(trajectory=eng.trajectory(), kf_count=int(st.kf_count), kf_accum=_host(st.kf_accum),
                kf_stamps=_host(st.kf_stamps))
    return view, _host(outs)


@pytest.fixture(scope="module")
def runs(request):
    return shared(request, "engine_runs", _runs)


def _runs():
    ref_seq, _ = ref_syn.simulate_sequence(**COURSE)
    seq, _ = synthetic.simulate_sequence(**COURSE)
    # the JAX engine's per-frame key chain (pipeline.py:405) and its draws
    key, keys = jax.random.key(ENGINE_SEED), []
    for _ in range(COURSE["n_frames"]):
        key, k1 = jax.random.split(key)
        keys.append(k1)

    def draws(frame_idx, shape):
        return np.asarray(jax.random.uniform(keys[frame_idx], shape))

    out = {}
    for kind, jdt, tdt in (("f64", jnp.float64, torch.float64), ("f32", jnp.float32, torch.float32)):
        ref_eng = ref_pipeline.Engine(_cfg(ref_presets), dtype=jdt, seed=ENGINE_SEED)
        out["ref_" + kind] = _engine_view(ref_eng, ref_datasets.replay(ref_eng, ref_seq, CAP, IMU_CAP))
        eng = pipeline.Engine(_cfg(presets), dtype=tdt, seed=ENGINE_SEED, device="cpu", uniforms=draws)
        out[kind] = _engine_view(eng, datasets.replay(eng, seq, CAP, IMU_CAP))
    return out


def _poses(outs, key="pose"):
    return np.stack([o[key] for o in outs])


def _flags(outs):
    return [(o["is_keyframe"], o["registration_ok"]) for o in outs]


def test_engine_float64_matches_reference(runs):
    _, ref = runs["ref_f64"]
    _, got = runs["f64"]
    assert _flags(got) == _flags(ref)
    assert [k for k, _ in _flags(got)] == [True, False, True, False, True, False]
    np.testing.assert_allclose(_poses(got), _poses(ref), rtol=0, atol=POSE_ATOL_F64)
    np.testing.assert_allclose(_poses(got, "odom"), _poses(ref, "odom"), rtol=0, atol=POSE_ATOL_F64)
    np.testing.assert_allclose([o["chi2"] for o in got], [o["chi2"] for o in ref], rtol=1e-4)
    np.testing.assert_allclose(_poses(got, "ego_velocity"), _poses(ref, "ego_velocity"), rtol=0, atol=1e-9)


def _band(got32, ref32, ref64):
    """(largest departure of the port's float32 run from the float64 run,
    the same for the reference's float32 run)."""
    return np.abs(got32 - ref64).max(), np.abs(ref32 - ref64).max()


def test_engine_float32_matches_reference(runs):
    _, ref = runs["ref_f32"]
    _, got = runs["f32"]
    _, ref64 = runs["ref_f64"]
    assert _flags(got) == _flags(ref)
    gap = np.abs(_poses(got) - _poses(ref)).max()
    assert gap <= POSE_ATOL_F32, gap
    err, ref_err = _band(*(_poses(o)[:, :3, 3] for o in (got, ref, ref64)))
    assert err <= 2.0 * ref_err + 0.01, (err, ref_err)
    chi2 = [np.array([o["chi2"] for o in outs]) for outs in (got, ref, ref64)]
    err, ref_err = _band(*chi2)
    assert err <= 2.0 * ref_err + 0.01 * chi2[2].max(), (err, ref_err)
    np.testing.assert_allclose(_poses(got, "ego_velocity"), _poses(ref, "ego_velocity"), rtol=0, atol=1e-4)
    assert all(o["pose"].dtype == np.float32 for o in got)


def test_engine_outputs_and_trajectory(runs):
    ref_eng, ref = runs["ref_f64"]
    eng, got = runs["f64"]
    for g, r in zip(got, ref):
        assert set(g) == set(r) and g["loop_found"] is False
        assert (g["floor"] is None) == (r["floor"] is None)
        assert len(g["dynamic_points"]) == len(r["dynamic_points"])
        if r["status"] is not None:
            assert set(g["status"]) == set(r["status"])
            assert g["status"]["num_correspondences"] == r["status"]["num_correspondences"]
    ts, poses = eng["trajectory"]
    ref_ts, ref_poses = ref_eng["trajectory"]
    np.testing.assert_array_equal(ts, ref_ts)
    np.testing.assert_array_equal(poses, _poses(got))
    np.testing.assert_allclose(poses, ref_poses, rtol=0, atol=POSE_ATOL_F64)
    assert eng["kf_count"] == ref_eng["kf_count"] == 3
    np.testing.assert_allclose(eng["kf_accum"], ref_eng["kf_accum"], atol=1e-6)
    np.testing.assert_array_equal(eng["kf_stamps"], ref_eng["kf_stamps"])


def test_engine_draws_come_from_its_seed():
    """Without the seam, the Engine's CPU generator makes a run repeatable
    from its seed (and the same draws on the card)."""
    seq, _ = synthetic.simulate_sequence(**dict(COURSE, n_frames=2))
    runs = [
        datasets.replay(pipeline.Engine(_cfg(presets), seed=s, device="cpu"), seq, CAP, IMU_CAP)
        for s in (3, 3)
    ]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a["pose"], b["pose"])
        np.testing.assert_array_equal(a["ego_velocity"], b["ego_velocity"])


@pytest.mark.parametrize("what", ["loop", "baro_prior", "scan_to_map", "gps", "cuda"])
def test_engine_refuses_what_this_slice_leaves_out(monkeypatch, what):
    """A CUDA engine without a card refuses to fall back. What earlier
    slices refused now runs: the asynchronous loop worker ("loop") and
    scan-to-map odometry run a few frames; the barometer and GPS priors land
    on the keyframes as a diagonal translation prior."""
    cfg = _cfg(presets)
    if what == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipeline.Engine(cfg)
        return
    seq, _ = synthetic.simulate_sequence(**dict(COURSE, n_frames=3 if what in ("loop", "scan_to_map") else 2))
    if what in ("loop", "scan_to_map"):
        change = {
            "loop": ("loop", dict(enable=True, async_loop=True, num_exclude_recent=0)),
            "scan_to_map": ("odometry", dict(enable_scan_to_map=True, max_submap_frames=2)),
        }[what]
        cfg = dataclasses.replace(cfg, **{change[0]: dataclasses.replace(getattr(cfg, change[0]), **change[1])})
        eng = pipeline.Engine(cfg, device="cpu")
        outs = datasets.replay(eng, seq, CAP, IMU_CAP)
        assert all(np.isfinite(o["pose"]).all() for o in outs)
        assert eng.state.kf_count == sum(o["is_keyframe"] for o in outs) >= 2
        if what == "loop":  # the worker ran a detection on the second keyframe
            assert eng._loop_thread is not None and not eng._loop_busy
            assert eng.loop_stats["detections_run"] + eng.loop_stats["skipped_worker_busy"] >= 1
            eng.close()
        else:
            assert bool(eng.state.odo.kf_valid[-2:].all())  # two keyframes in the submap
        return
    if what == "gps":
        seq.gps_stamps = seq.frame_stamps.copy()
        seq.gps_utm = np.array([[100.0, 200.0, 3.0], [100.3, 200.0, 3.0]])
    else:
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, baro_z_prior=True))
    eng = pipeline.Engine(cfg, device="cpu")
    datasets.replay(eng, seq, CAP, IMU_CAP)
    g = eng.state.graph
    assert bool(g.gps_mask[0]) and eng.state.kf_count >= 1
    if what == "gps":  # the first fix is the UTM origin
        np.testing.assert_array_equal(g.gps_xyz[0].numpy(), 0.0)
        np.testing.assert_allclose(g.gps_info[0].numpy(), [0.01, 0.01, 0.04])
    else:  # z only, relative to the first reading
        np.testing.assert_allclose(g.gps_info[0].numpy(), [0.0, 0.0, 4.0])
        assert float(g.gps_xyz[0, 2]) == 0.0


def test_simulated_sequence_identical():
    """Radar frames, dynamic objects, IMU stream, barometer and ground truth:
    the same numbers as the reference from the same seed."""
    kw = dict(seed=4, n_frames=4, capacity=300, n_dynamic=2, cartesian_noise=0.01, world_points=5000)
    ref, ref_world = ref_syn.simulate_sequence(**kw)
    got, world = synthetic.simulate_sequence(**kw)
    np.testing.assert_array_equal(world, ref_world)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(ref, f.name), err_msg=f.name)
    args = (0.1, 0.35)
    for a, b in zip(synthetic.circular_imu_samples(*args), ref_syn.circular_imu_samples(*args)):
        np.testing.assert_array_equal(a, b)


def test_radar_sequence_container_is_shared(tmp_path):
    """A file written by either package reads back in the other, and the
    per-frame accessors agree."""
    seq, _ = synthetic.simulate_sequence(**dict(COURSE, n_frames=3))
    seq.gps_stamps, seq.gps_utm, seq.gps_cov = np.array([0.15]), np.ones((1, 3)), np.full((1, 3), 2.0)
    seq.save(str(tmp_path / "port.npz"))
    ref = ref_datasets.RadarSequence.load(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "ref.npz"))
    back = datasets.RadarSequence.load(str(tmp_path / "ref.npz"))
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(back, f.name), getattr(seq, f.name), err_msg=f.name)
    for t in (0.0, 0.15, 0.31):
        for a, b in zip(back.imu_between(t - 0.15, t, IMU_CAP), ref.imu_between(t - 0.15, t, IMU_CAP)):
            np.testing.assert_array_equal(a, b)
        assert back.baro_at(t) == ref.baro_at(t)
        for a, b in zip(back.gps_at(t), ref.gps_at(t)):
            np.testing.assert_array_equal(a, b)


def test_ate_copy_matches_reference():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(40, 3)) * 5
    est = gt + rng.normal(size=(40, 3)) * 0.1 + [1.0, 2.0, 0.0]
    for align in (True, False):
        assert ate.ate(est, gt, align=align) == ref_ate.ate(est, gt, align=align)
    T = np.tile(np.eye(4), (30, 1, 1))
    T[:, :3, 3] = np.cumsum(rng.normal(size=(30, 3)), 0)
    T2 = T.copy()
    T2[:, :3, 3] += rng.normal(size=(30, 3)) * 0.05
    assert ate.relative_error(T, T2, 5) == ref_ate.relative_error(T, T2, 5)


def reference_course_ate() -> dict:
    """The JAX engine over chip_smoke.py's engine course: full ATE (SE(3)
    aligned, as eval/validation.py scores it), keyframes, converged share."""
    from rivslam_tpu.eval.validation import COURSES

    seq, _ = ref_syn.simulate_sequence(seed=21, **COURSES["cp"])
    cfg = _cfg(ref_presets)
    cfg = dataclasses.replace(cfg, floor=ref_presets.get("cp").floor)  # the preset's own floor
    eng = ref_pipeline.Engine(cfg, dtype=jnp.float32, seed=ENGINE_SEED)
    outs = ref_datasets.replay(eng, seq, capacity=1024, imu_capacity=64)
    ts, poses = eng.trajectory()
    gt = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses
    gt = gt[[int(np.argmin(np.abs(seq.gt_stamps - t))) for t in ts]]
    return {
        "frames": len(outs),
        "full_ate_m": ref_ate.ate(poses[:, :3, 3], gt[:, :3, 3])["rmse"],
        "keyframes": int(sum(o["is_keyframe"] for o in outs)),
        "converged_share": float(np.mean([o["registration_ok"] for o in outs[1:]])),
    }


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(reference_course_ate()))
