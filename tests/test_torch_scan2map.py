"""The port's scan-to-map odometry (``frontend/scan2map.py``) against the JAX
package's on the CPU.

``scan2map.step`` runs over a few frames of a synthetic course with the same
prepared clouds (the JAX ``prepare``'s, so that the two steps see the same
covariances) in both packages, in float64 and in float32, at capacity 256
with a submap of 3 keyframes (768 points). The configuration is the garden
preset's (RBF covariances at width 4.0, scan-to-map on) with IMU roll/pitch
fusion on, so that the scan-to-map pose takes the fused branch. Then the
Engine with the garden preset (loop closure off) against the JAX engine,
with the JAX engine's RANSAC draws injected (the ``uniforms`` seam), as
tests/test_torch_engine.py does for the cp preset.

The course is tests/test_torch_engine.py's: 0.3 m frame steps, so that a
keyframe comes every other frame and the submap is rebuilt three times.

Run as a script (``PYTHONPATH=.:tests python tests/test_torch_scan2map.py``,
about 6 minutes), it prints the JAX engine's figures on chip_smoke.py's two
garden runs (the 260-frame "garden" validation course at capacity 1024,
float32 on the CPU, engine seed 0): full-trajectory ATE, loop-corrected and
the window backend's own, keyframes and loops closed. chip_smoke.py holds
the port's card runs to them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

from rivslam_tpu import pipeline as ref_pipeline
from rivslam_tpu import presets as ref_presets
from rivslam_tpu.core.pointcloud import RadarCloud as RefCloud
from rivslam_tpu.frontend import apdgicp as ref_apdgicp
from rivslam_tpu.frontend import scan2map as ref_scan2map
from rivslam_tpu.io import datasets as ref_datasets
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu_torch import pipeline, presets
from rivslam_tpu_torch.frontend import apdgicp, scan2map
from rivslam_tpu_torch.io import datasets, synthetic

COURSE = dict(seed=21, radius=8.0, omega=0.25, dt=0.15, n_frames=6, capacity=256,
              world_points=20000, extent=30.0)
CAP, IMU_CAP, ENGINE_SEED, SUBMAP = 256, 32, 0, 3
POSE_ATOL_F64 = 1e-6
# float32: the float32 band of tests/test_torch_engine.py (the reference's
# own float32 run departs from its float64 run by up to 0.16 m there)
POSE_ATOL_F32 = 0.25


def _cfg(mod):
    cfg = mod.get("garden")
    return dataclasses.replace(
        cfg,
        odometry=dataclasses.replace(cfg.odometry, max_submap_frames=SUBMAP, enable_imu_fusion=True),
        loop=dataclasses.replace(cfg.loop, enable=False),
        floor=dataclasses.replace(cfg.floor, floor_pts_thresh=12),
    )


def _t(x, dtype):
    a = np.array(x)
    return torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f" else None)


def _prepared(jdt):
    """The course's clouds as the JAX prepare leaves them, with the frames'
    stamps, ego velocities (from ground truth) and IMU roll/pitch."""
    seq, _ = ref_syn.simulate_sequence(**COURSE)
    reg = _cfg(ref_presets).registration
    out = []
    for i in range(seq.num_frames):
        f = seq.frame(i)
        cl = RefCloud.from_numpy(f["xyz"], CAP, doppler=f["doppler"], intensity=f["intensity"], dtype=jdt)
        p = ref_apdgicp.prepare(cl.xyz, cl.mask, reg)
        # the frame's body velocity, roughly: the speed along the circle
        v = np.array([COURSE["radius"] * COURSE["omega"], 0.0, 0.0])
        roll, pitch = 0.01 * i, -0.005 * i
        out.append((p, f["stamp"], v, roll, pitch))
    return out


def _run_both(jdt, tdt):
    rcfg, cfg = _cfg(ref_presets), _cfg(presets)
    frames = _prepared(jdt)
    p0, t0 = frames[0][0], frames[0][1]
    rst = ref_scan2map.init_state(p0, jnp.asarray(t0, jdt), rcfg.odometry, dtype=jdt)
    st = scan2map.init_state(apdgicp.PreparedCloud(*(_t(a, tdt) for a in (p0.xyz, p0.mask, p0.cov))),
                             torch.tensor(t0, dtype=tdt), cfg.odometry, dtype=tdt)
    ref_step = jax.jit(lambda s, p, v, t, r, pi, ok: ref_scan2map.step(
        s, p, v, t, rcfg.odometry, rcfg.registration, imu_roll=r, imu_pitch=pi, imu_valid=ok))
    got, want = [], []
    for p, t, v, roll, pitch in frames[1:]:
        rst, rout = ref_step(rst, p, jnp.asarray(v, jdt), jnp.asarray(t, jdt), jnp.asarray(roll, jdt),
                             jnp.asarray(pitch, jdt), jnp.asarray(True))
        src = apdgicp.PreparedCloud(*(_t(a, tdt) for a in (p.xyz, p.mask, p.cov)))
        st, out = scan2map.step(st, src, _t(v, tdt), torch.tensor(t, dtype=tdt), cfg.odometry,
                                cfg.registration, imu_roll=torch.tensor(roll, dtype=tdt),
                                imu_pitch=torch.tensor(pitch, dtype=tdt), imu_valid=torch.tensor(True))
        want.append(rout)
        got.append(out)
    return (rst, want), (st, got)


@pytest.fixture(scope="module")
def f64():
    return _run_both(jnp.float64, torch.float64)


def test_scan2map_step_float64_matches_reference(f64):
    (rst, want), (st, got) = f64
    assert [bool(o.is_keyframe) for o in got] == [bool(o.is_keyframe) for o in want]
    assert sum(bool(o.is_keyframe) for o in got) >= 2  # the submap is rebuilt
    for o, r in zip(got, want):
        np.testing.assert_allclose(o.odom.numpy(), np.asarray(r.odom), rtol=0, atol=POSE_ATOL_F64)
        np.testing.assert_allclose(o.trans_delta.numpy(), np.asarray(r.trans_delta), rtol=0, atol=POSE_ATOL_F64)
        assert bool(o.reg.converged) == bool(r.reg.converged)
        assert int(o.reg.num_correspondences) == int(r.reg.num_correspondences)
        np.testing.assert_allclose(float(o.accum_distance), float(r.accum_distance), rtol=0, atol=POSE_ATOL_F64)
    # the carried state: ring buffer, submap and the scan-to-map poses
    np.testing.assert_array_equal(st.kf_valid.numpy(), np.asarray(rst.kf_valid))
    np.testing.assert_array_equal(st.kf_mask.numpy(), np.asarray(rst.kf_mask))
    np.testing.assert_array_equal(st.target.mask.numpy(), np.asarray(rst.target.mask))
    for name in ("kf_xyz", "kf_pose", "prev_trans_s2m", "keyframe_pose_s2m"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(rst, name)), rtol=0,
                                   atol=POSE_ATOL_F64, err_msg=name)
    m = st.target.mask.numpy()
    np.testing.assert_allclose(st.target.xyz.numpy()[m], np.asarray(rst.target.xyz)[m], rtol=0, atol=POSE_ATOL_F64)
    # the covariance E_w[x x^T] - mean mean^T cancels most digits for a point
    # with few neighbours in reach: measured 1.5e-6 at most, over 4 of 6912
    np.testing.assert_allclose(st.target.cov.numpy()[m], np.asarray(rst.target.cov)[m], rtol=0, atol=1e-5)


def test_scan2map_step_float32_matches_reference():
    (_, want), (_, got) = _run_both(jnp.float32, torch.float32)
    assert [bool(o.is_keyframe) for o in got] == [bool(o.is_keyframe) for o in want]
    gap = max(np.abs(o.odom.numpy() - np.asarray(r.odom)).max() for o, r in zip(got, want))
    assert gap <= POSE_ATOL_F32, gap
    assert all(o.odom.dtype == torch.float32 for o in got)


def test_build_submap_matches_reference():
    """The merged submap's geometry and its RBF covariances, with an
    invalid ring slot and ragged masks. The clouds are dense (0.7 m
    spread), so that every point has neighbours within the kernel's reach:
    an isolated point's covariance is rounding noise in either package."""
    rng = np.random.default_rng(5)
    S, N = 3, 200
    xyz = rng.normal(size=(S, N, 3)) * 0.7
    mask = rng.uniform(size=(S, N)) > 0.3
    valid = np.array([False, True, True])
    ang = rng.normal(size=(S, 3)) * 0.2
    poses = np.tile(np.eye(4), (S, 1, 1))
    for s in range(S):
        poses[s, :3, :3] = _rot(ang[s])
        poses[s, :3, 3] = rng.normal(size=3)
    reg = _cfg(presets).registration
    got = scan2map._build_submap(*(torch.as_tensor(a) for a in (xyz, mask, poses, valid, poses[-1])), reg)
    want = ref_scan2map._build_submap(*(jnp.asarray(a) for a in (xyz, mask, poses, valid, poses[-1])),
                                      _cfg(ref_presets).registration)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert not got.mask.numpy()[:N].any()  # the invalid slot contributes nothing
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=0, atol=1e-12)
    m = got.mask.numpy()
    np.testing.assert_allclose(got.cov.numpy()[m], np.asarray(want.cov)[m], rtol=1e-7, atol=1e-12)


def _rot(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def test_engine_scan_to_map_matches_reference():
    """The Engine with the garden preset (scan-to-map on, loop closure off,
    K1's plain twin on) against the JAX engine, float64, the JAX engine's
    RANSAC draws injected."""
    ref_seq, _ = ref_syn.simulate_sequence(**COURSE)
    seq, _ = synthetic.simulate_sequence(**COURSE)
    key, keys = jax.random.key(ENGINE_SEED), []
    for _ in range(COURSE["n_frames"]):
        key, k1 = jax.random.split(key)
        keys.append(k1)

    def draws(frame_idx, shape):
        return np.asarray(jax.random.uniform(keys[frame_idx], shape))

    def cfg(mod):
        c = _cfg(mod)
        return dataclasses.replace(c, registration=dataclasses.replace(
            c.registration, use_pallas_correspondence=True))

    ref_eng = ref_pipeline.Engine(cfg(ref_presets), dtype=jnp.float64, seed=ENGINE_SEED)
    ref = ref_datasets.replay(ref_eng, ref_seq, CAP, IMU_CAP)
    eng = pipeline.Engine(cfg(presets), dtype=torch.float64, seed=ENGINE_SEED, device="cpu", uniforms=draws)
    got = datasets.replay(eng, seq, CAP, IMU_CAP)
    assert isinstance(eng.state.odo, scan2map.SubmapOdometryState)
    assert [o["is_keyframe"] for o in got] == [o["is_keyframe"] for o in ref]
    assert sum(o["is_keyframe"] for o in got) >= 3
    for key in ("pose", "odom"):
        np.testing.assert_allclose(np.stack([o[key] for o in got]), np.stack([o[key] for o in ref]),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(eng.state.kf_accum, ref_eng.state.kf_accum, atol=1e-6)
    np.testing.assert_allclose([o["chi2"] for o in got], [o["chi2"] for o in ref], rtol=1e-4)


def garden_cfg(mod):
    """chip_smoke.py's first garden run: the "garden" preset as shipped
    (scan-to-map on, loop closure on), with the fused correspondence kernel
    (K1) on."""
    cfg = mod.get("garden")
    return dataclasses.replace(
        cfg, registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True)
    )


def garden_course_cfg_reference():
    """chip_smoke.py's second garden run, as the reference's validation
    harness builds it: the garden preset for instantaneous synthetic scans
    (no deskew or under-floor removal, ego-velocity guesses, loop gates 40 m
    / 5 m), K1 on."""
    from rivslam_tpu.eval.validation import build_course_cfg

    return build_course_cfg("garden", reg_overrides={"use_pallas_correspondence": True})


def test_chip_smoke_garden_configs_are_the_references():
    """chip_smoke.py's garden runs use the configurations whose JAX figures
    they are held to; the course configuration is the port's validation
    harness's (eval/validation.build_course_cfg), which builds the
    reference's."""
    from test_torch_engine_loop import _chip_smoke

    from rivslam_tpu_torch.eval import validation

    cs = _chip_smoke()
    assert dataclasses.asdict(cs.garden_cfg(presets)) == dataclasses.asdict(garden_cfg(ref_presets))
    port_course = validation.build_course_cfg("garden", reg_overrides={"use_pallas_correspondence": True})
    assert dataclasses.asdict(port_course) == dataclasses.asdict(garden_course_cfg_reference())
    assert cs.garden_course_cfg() == port_course


def reference_garden(cfg, seed: int = ENGINE_SEED) -> dict:
    """The JAX engine over the 260-frame "garden" validation course under
    ``cfg``, engine seed ``seed``, float32 on the CPU: full ATE (loop-
    corrected and the window backend's own), keyframes, loops."""
    from rivslam_tpu.eval import ate as ref_ate
    from rivslam_tpu.eval.validation import COURSES

    seq, _ = ref_syn.simulate_sequence(seed=21, **COURSES["garden"])
    eng = ref_pipeline.Engine(cfg, dtype=jnp.float32, seed=seed)
    outs = ref_datasets.replay(eng, seq, capacity=1024, imu_capacity=64)
    gt = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses
    res = {"frames": len(outs), "keyframes": int(sum(o["is_keyframe"] for o in outs)),
           "loops": int(eng.loop_stats["accepted"]), "loop_stats": dict(eng.loop_stats)}
    for corrected in (True, False):
        ts, poses = eng.trajectory(corrected=corrected)
        g = gt[[int(np.argmin(np.abs(seq.gt_stamps - t))) for t in ts]]
        res["full_ate_m" if corrected else "uncorrected_ate_m"] = ref_ate.ate(poses[:, :3, 3], g[:, :3, 3])["rmse"]
    return res


if __name__ == "__main__":
    import json

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({"garden": reference_garden(garden_cfg(ref_presets)), "seed": ENGINE_SEED}), flush=True)
    print(json.dumps({"garden-course": reference_garden(garden_course_cfg_reference()), "seed": ENGINE_SEED}),
          flush=True)
