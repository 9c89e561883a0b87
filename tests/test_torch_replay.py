"""Whole-sequence replay in the port against its own per-frame driver and
against the JAX package on the CPU: ``Engine.replay_sequence``,
``Engine.replay_fleet`` and ``frontend/replay_device.replay_odometry``.

The course and configuration are tests/test_torch_engine.py's: the "cp"
validation course's world with 0.15 s frames, 6 frames at capacity 256 and
IMU capacity 32, the "cp" preset with loop closure off, K1 on and
``floor_pts_thresh`` scaled to the capacity.

- The port's replay is bitwise its ``process_frame`` loop under the same
  loop-off configuration and seed (the same frame step, the same draws).
- Against the JAX replay, the JAX engine's draws injected through the
  ``uniforms`` seam: float64 poses within 1e-4 m, float32 within twice the
  reference's own float32 departure from its float64 run (the engine
  tests' tolerances).
- ``replay_fleet[b]`` is bitwise the single replay of sequence b on an
  Engine seeded with sequence b's fleet seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shared_cache  # noqa: F401  (one torch thread per test process)

from rivslam_tpu import pipeline as ref_pipeline
from rivslam_tpu import presets as ref_presets
from rivslam_tpu.frontend import replay_device as ref_replay_device
from rivslam_tpu.io import datasets as ref_datasets
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu_torch import pipeline, presets
from rivslam_tpu_torch.frontend import replay_device
from rivslam_tpu_torch.io import datasets, synthetic

COURSE = dict(seed=21, radius=8.0, omega=0.25, dt=0.15, n_frames=6, capacity=256,
              world_points=20000, extent=30.0)
CAP, IMU_CAP, ENGINE_SEED = 256, 32, 0
POSE_ATOL_F64 = 1e-4  # as tests/test_torch_engine.py (measured there 7.4e-6 m)
KEYS = ("odom", "pose", "is_keyframe", "converged", "chi2", "ego_vel", "solver_iterations")


def _cfg(mod):
    cfg = mod.get("cp")
    return dataclasses.replace(
        cfg,
        loop=dataclasses.replace(cfg.loop, enable=False),
        floor=dataclasses.replace(cfg.floor, floor_pts_thresh=12),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )


@pytest.fixture(scope="module")
def course():
    seq, _ = synthetic.simulate_sequence(**COURSE)
    return seq, datasets.stack_sequence(seq, CAP, IMU_CAP)


def _jax_draws(n_frames, seed=ENGINE_SEED):
    """The JAX engine's per-frame key chain and a seam drawing from it."""
    key, keys = jax.random.key(seed), []
    for _ in range(n_frames):
        key, k1 = jax.random.split(key)
        keys.append(k1)
    return lambda i, shape: np.asarray(jax.random.uniform(keys[i], shape))


def _assert_bitwise(got: dict, want: dict):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_replay_equals_process_frame_bitwise():
    """The replay is the per-frame driver's loop-off run, bit for bit, over
    4 frames, and leaves the Engine's session state as it found it."""
    seq, _ = synthetic.simulate_sequence(**dict(COURSE, n_frames=4))
    stacked = datasets.stack_sequence(seq, CAP, IMU_CAP)
    eng = pipeline.Engine(_cfg(presets), seed=ENGINE_SEED, device="cpu")
    outs = datasets.replay(eng, seq, CAP, IMU_CAP)
    want = {
        "odom": np.stack([o["odom"] for o in outs]), "pose": np.stack([o["pose"] for o in outs]),
        "is_keyframe": np.array([o["is_keyframe"] for o in outs]),
        "converged": np.array([o["registration_ok"] for o in outs]),
        "chi2": np.array([o["chi2"] for o in outs], np.float32),
        "ego_vel": np.stack([o["ego_velocity"] for o in outs]),
    }
    rep_eng = pipeline.Engine(_cfg(presets), seed=ENGINE_SEED, device="cpu")
    rep = rep_eng.replay_sequence(stacked)
    assert rep["pose"].shape == (4, 4, 4)
    assert rep["is_keyframe"].tolist() == [True, False, True, False]
    for k, v in want.items():
        assert rep[k].dtype == v.dtype, k
        np.testing.assert_array_equal(rep[k], v, err_msg=k)
    assert rep["solver_iterations"].dtype == np.int32 and (rep["solver_iterations"][1:] >= 1).all()
    st = rep_eng.state
    assert st.frame_idx == 0 and st.odo is None and st.trajectory == [] and st.kf_count == 0
    # the replay drew its scores from the Engine's generator, as process_frame does
    assert torch.equal(rep_eng._generator.get_state(), eng._generator.get_state())


def test_replay_matches_reference(course):
    """The JAX replay (one lax.scan) against the port's, the JAX draws
    injected: float64 within POSE_ATOL_F64, the same keyframes, convergence
    and window iterations; float32 within twice the reference's own float32
    departure from float64 (plus 1 cm, 1% of chi2)."""
    ref_seq, _ = ref_syn.simulate_sequence(**COURSE)
    ref_stacked = ref_datasets.stack_sequence(ref_seq, CAP, IMU_CAP)
    _, stacked = course
    for a, b in zip(ref_stacked.values(), stacked.values()):
        np.testing.assert_array_equal(a, b)
    draws = _jax_draws(COURSE["n_frames"])
    ref, got = {}, {}
    for kind, jdt, tdt in (("f64", jnp.float64, torch.float64), ("f32", jnp.float32, torch.float32)):
        ref[kind] = ref_pipeline.Engine(_cfg(ref_presets), dtype=jdt, seed=ENGINE_SEED).replay_sequence(ref_stacked)
        got[kind] = pipeline.Engine(_cfg(presets), dtype=tdt, seed=ENGINE_SEED, device="cpu",
                                    uniforms=draws).replay_sequence(stacked)
        for k in ("is_keyframe", "converged"):
            np.testing.assert_array_equal(got[kind][k], ref[kind][k])
    g, r = got["f64"], ref["f64"]
    for k in ("pose", "odom"):
        np.testing.assert_allclose(g[k], r[k], rtol=0, atol=POSE_ATOL_F64)
    np.testing.assert_allclose(g["chi2"], r["chi2"], rtol=1e-4)
    np.testing.assert_allclose(g["ego_vel"], r["ego_vel"], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(g["solver_iterations"], r["solver_iterations"])
    for k, floor in (("pose", 0.01), ("chi2", 0.01 * np.abs(r["chi2"]).max())):
        err = np.abs(got["f32"][k] - r[k]).max()
        ref_err = np.abs(ref["f32"][k] - r[k]).max()
        assert err <= 2.0 * ref_err + floor, (k, err, ref_err)


def test_replay_fleet_equals_single_replays(course, tmp_path):
    """Two 3-frame sequences as a fleet: each equals, bitwise, the single
    replay on an Engine seeded with its fleet seed; through the seam, each
    sequence's draws are called with its index; on a mesh of one rank the
    fleet is the unmeshed fleet, bitwise (more ranks:
    tests/test_torch_dist.py)."""
    stacks = [datasets.stack_sequence(synthetic.simulate_sequence(**dict(COURSE, n_frames=3, seed=s))[0],
                                      CAP, IMU_CAP) for s in (21, 22)]
    batch = {k: np.stack([st[k] for st in stacks]) for k in stacks[0]}
    seed = 5
    fleet = pipeline.Engine(_cfg(presets), seed=seed, device="cpu").replay_fleet(batch)
    assert fleet["pose"].shape == (2, 3, 4, 4)
    base = int(torch.randint(0, 2**62, (), generator=torch.Generator().manual_seed(seed)))
    for b in range(2):
        single = pipeline.Engine(_cfg(presets), seed=pipeline.fleet_seed(base, b), device="cpu")
        _assert_bitwise({k: v[b] for k, v in fleet.items()}, single.replay_sequence(stacks[b]))
    assert pipeline.fleet_seed(base, 0) != pipeline.fleet_seed(base, 1)

    calls = []

    def seam(i, shape, sequence=None):
        calls.append((sequence, i))
        return np.random.default_rng([sequence, i]).random(shape, dtype=np.float32)

    two = {k: v[:, :2] for k, v in batch.items()}
    fleet = pipeline.Engine(_cfg(presets), device="cpu", uniforms=seam).replay_fleet(two)
    assert sorted(set(calls)) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    single = pipeline.Engine(_cfg(presets), device="cpu", uniforms=lambda i, shape: seam(i, shape, sequence=1))
    _assert_bitwise({k: v[1] for k, v in fleet.items()}, single.replay_sequence({k: v[1] for k, v in two.items()}))
    from rivslam_tpu_torch.dist import mesh as mesh_mod

    mesh_mod.init_world("gloo", 0, 1, str(tmp_path / "init"), timeout_s=30.0)
    try:
        meshed = pipeline.Engine(_cfg(presets), device="cpu", uniforms=seam).replay_fleet(
            two, mesh=mesh_mod.make_mesh(1, 1))
    finally:
        torch.distributed.destroy_process_group()
    _assert_bitwise(meshed, fleet)


def test_replay_odometry_matches_reference(course):
    """The front end alone over the stacked sequence, float64: the same
    keyframes and convergence, poses within POSE_ATOL_F64."""
    _, stacked = course
    cfg, ref_cfg = _cfg(presets), _cfg(ref_presets)
    F = COURSE["n_frames"]
    ego = np.tile([0.5, 0.1, 0.0], (F, 1))
    args = (stacked["xyz"].astype(np.float64), stacked["mask"], ego, stacked["stamps"])
    ref = ref_replay_device.replay_odometry(*(jnp.asarray(a) for a in args), ref_cfg.odometry,
                                            ref_cfg.registration)
    got = replay_device.replay_odometry(*args, cfg.odometry, cfg.registration, device="cpu")
    assert got[0].dtype == torch.float64
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[1].numpy().sum() >= 2
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=POSE_ATOL_F64)
