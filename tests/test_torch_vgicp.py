"""The port's VGICP / NDT registration family against the JAX package on
the CPU: the Gaussian voxel map (``ops/voxel.gaussian_voxel_map``), the
DIRECT1 / DIRECT7 and KDTREE voxel correspondences, the tiled nearest
neighbour (``ops/knn.nearest_neighbor_tiled``), ``register_vgicp`` and
``register_ndt`` (P2D and D2D) through ``register_dispatch``, and the
Engine with ``method="VGICP"`` and ``method="NDT_OMP"``.

The registration scene is the reference's tests/test_vgicp.py scene at 512
points: one simulated world, the target at 2 m height and the source 0.36 m
and 1.7 deg off it.

Run as a script (``PYTHONPATH=.:tests python tests/test_torch_vgicp.py``,
about 4 minutes), it prints the JAX engine's figures on chip_smoke.py's
voxel runs: the "cp" validation course (120 frames at capacity 1024,
float32 on the CPU, engine seed 0) under the validation harness's
configuration with ``method="VGICP"`` and ``method="NDT_OMP"``:
full-trajectory ATE (loop-corrected and the window backend's own),
keyframes and loops closed. chip_smoke.py holds the port's card runs to them.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shared_cache  # noqa: F401  (one torch thread per test process)

from rivslam_tpu import pipeline as ref_pipeline
from rivslam_tpu.core import lie as ref_lie
from rivslam_tpu.core.config import RegistrationConfig as RefRegistrationConfig
from rivslam_tpu.eval import validation as ref_validation
from rivslam_tpu.frontend import apdgicp as ref_apdgicp
from rivslam_tpu.frontend import vgicp as ref_vgicp
from rivslam_tpu.io import datasets as ref_datasets
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu.ops import knn as ref_knn
from rivslam_tpu.ops import voxel as ref_voxel
from rivslam_tpu_torch import pipeline
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.eval import validation
from rivslam_tpu_torch.frontend import apdgicp, vgicp
from rivslam_tpu_torch.io import datasets, synthetic
from rivslam_tpu_torch.ops import knn, nn_argmin, voxel

CPU = "cpu"
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}
# poses after a full registration: float64 runs the same arithmetic in both
# packages (measured 5.5e-15). In float32 the port is held, as the engine
# tests hold it, to twice the reference's own float32 departure from its
# float64 run, plus 1e-5 (measured: 2.0e-6 from the reference's float32 pose)
POSE_ATOL_F64 = 1e-10
# the engine course of tests/test_torch_engine.py, 4 frames, loop off
COURSE = dict(seed=21, radius=8.0, omega=0.25, dt=0.15, n_frames=4, capacity=256,
              world_points=20000, extent=30.0)
CAP, IMU_CAP, ENGINE_SEED = 256, 32, 0
ENGINE_POSE_ATOL_F64 = 1e-4  # as tests/test_torch_engine.py


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(8)
    world = ref_syn.make_world(rng, n_points=12000)
    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 2.0]
    T_rel = np.asarray(ref_lie.se3_exp(jnp.asarray([0.0, 0.0, 0.03, 0.3, -0.2, 0.03])))
    tgt = ref_syn.observe(world, T0, rng, capacity=512, noise=0.01, dtype=jnp.float64)
    src = ref_syn.observe(world, T0 @ T_rel, rng, capacity=512, noise=0.01, dtype=jnp.float64)
    return tuple(np.asarray(a) for a in (src.xyz, src.mask, tgt.xyz, tgt.mask)), T_rel


def _both(a, kind, mask=False):
    """The same numpy array for the reference (jax) and the port (torch)."""
    tdt, jdt = DTYPES[kind]
    if mask:
        return jnp.asarray(a), torch.as_tensor(a)
    return jnp.asarray(a, jdt), torch.as_tensor(a, dtype=tdt)


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_gaussian_voxel_map_equals_reference(scene, kind):
    """Coords, means, covariances and counts bitwise (one stable sort and
    sequential segment sums in both), and the packed keys of the table."""
    (_, _, tx, tm), _ = scene
    xm = np.where(tm[:, None], tx, 1e6)
    rx, px = _both(xm, kind)
    rm, pm = _both(tm, kind, mask=True)
    ref = ref_voxel.gaussian_voxel_map(rx, rm, 1.0, 2048)
    got = voxel.gaussian_voxel_map(px, pm, 1.0, 2048)
    assert int((np.asarray(ref[3]) > 0).sum()) > 200
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(voxel.pack_voxel_coords(got[0]).numpy(),
                                  np.asarray(ref_voxel.pack_voxel_coords(ref[0])))
    # batched: each problem's table is the single problem's
    both = voxel.gaussian_voxel_map(torch.stack([px, px.flip(0)]), torch.stack([pm, pm.flip(0)]), 1.0, 2048)
    for r, g in zip(ref, both):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))


def test_build_voxel_map_matches_reference(scene):
    """The regularized voxel map: the table bitwise, the clamped-eigenvalue
    covariances within 1e-12 (float64; the two eigh routines differ in the
    last bits)."""
    (_, _, tx, tm), _ = scene
    cfg, rcfg = RegistrationConfig(), RefRegistrationConfig()
    ref = ref_vgicp.build_voxel_map(*_both(tx, "f64")[:1], jnp.asarray(tm), rcfg)
    got = vgicp.build_voxel_map(torch.as_tensor(tx), torch.as_tensor(tm), cfg)
    for name in ("coords", "mean", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(ref.cov), rtol=0, atol=1e-12)
    assert (np.linalg.eigvalsh(got.cov.numpy()[got.valid.numpy()]) > 0).all()


@pytest.mark.parametrize("neighborhood", ["DIRECT1", "DIRECT7", "KDTREE"])
def test_voxel_correspondences_match_reference(scene, neighborhood):
    """At a pose off the solution: the same voxels take part (exactly), the
    packed-key one-hot gathers their means bitwise, the Mahalanobis weights
    within 1e-9 relative (float64)."""
    (sx, sm, tx, tm), T_rel = scene
    cfg, rcfg = RegistrationConfig(), RefRegistrationConfig()
    src_r = ref_apdgicp.estimate_covariances(jnp.asarray(sx), jnp.asarray(sm), rcfg)
    vm_r = ref_vgicp.build_voxel_map(jnp.asarray(tx), jnp.asarray(tm), rcfg)
    T = np.asarray(ref_lie.se3_exp(jnp.asarray([0.01, -0.02, 0.02, 0.1, 0.05, -0.05]))) @ T_rel
    mean_r, corr_r, mah_r = ref_vgicp._voxel_correspondences(jnp.asarray(T), src_r, vm_r, rcfg, neighborhood)
    src = apdgicp._map(apdgicp.PreparedCloud(*(torch.as_tensor(np.asarray(a)) for a in (
        src_r.xyz, src_r.mask, src_r.cov))), lambda t: t[None])
    vm = vgicp.build_voxel_map(torch.as_tensor(tx)[None], torch.as_tensor(tm)[None], cfg)
    mean, corr, mah = vgicp._voxel_correspondences(torch.as_tensor(T)[None], src.xyz, src.mask, src.cov,
                                                   vm, cfg, neighborhood)
    corr_r = np.asarray(corr_r)
    assert corr_r.sum() > 50
    np.testing.assert_array_equal(corr[0].numpy(), corr_r)
    np.testing.assert_array_equal(mean[0].numpy()[corr_r], np.asarray(mean_r)[corr_r])
    np.testing.assert_allclose(mah[0].numpy(), np.asarray(mah_r), rtol=1e-9, atol=1e-12)


def test_nearest_neighbor_tiled_matches_reference():
    """K3's function in tiles: ties across a tile edge go to the earlier
    tile, as in the reference; idx bitwise and d2 within float32 rounding,
    and the same winners as K3's plain twin (which scans in its own tiles)."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(300, 3)).astype(np.float32) * 5
    r = rng.normal(size=(700, 3)).astype(np.float32) * 5
    m = rng.random(700) < 0.9
    m[[255, 256]] = True
    r[256] = r[255]  # an exact tie across the 256-ref tile edge
    q[0] = r[255]
    ref_idx, ref_d2 = ref_knn.nearest_neighbor_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), tile=256)
    idx, d2 = knn.nearest_neighbor_tiled(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(m), tile=256)
    # the expanded form |q|^2 + |r|^2 - 2 q.r: 4 float32 ulps of its largest term
    atol = 4 * 2.0**-23 * float((q * q).sum(1).max() + (r * r).sum(1).max())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2), rtol=0, atol=atol)
    assert int(idx[0]) == 255
    k3_idx, k3_d2 = nn_argmin.nearest_neighbor_plain(torch.as_tensor(q)[None], torch.as_tensor(r)[None],
                                                     torch.as_tensor(m)[None])
    np.testing.assert_array_equal(idx.numpy(), k3_idx[0].numpy())
    np.testing.assert_allclose(d2.numpy(), torch.clamp_min(k3_d2[0], 0).numpy(), rtol=0, atol=atol)
    # one tile against many: the same answer
    idx1, _ = knn.nearest_neighbor_tiled(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(m), tile=4096)
    np.testing.assert_array_equal(idx1.numpy(), idx.numpy())


# the other names of each path (FAST_VGICP, NDT, NDT_CUDA) dispatch to the
# same functions: test_dispatch_takes_every_method_the_reference_takes
REG_CASES = {
    "VGICP": dict(method="VGICP"),
    "FAST_VGICP_CUDA KDTREE": dict(method="FAST_VGICP_CUDA", vgicp_neighborhood="KDTREE"),
    # NDT at the reference's convergence epsilon (registrations.cpp:56; see
    # the reference's tests/test_vgicp.py)
    "NDT_OMP": dict(method="NDT_OMP", transformation_epsilon=1e-2),
}


# KDTREE's nearest-7 cut is the one float32 case that flips voxels: held in float64
@pytest.mark.parametrize("case,kind", [(c, k) for c in REG_CASES for k in ("f64", "f32")
                                       if (c, k) != ("FAST_VGICP_CUDA KDTREE", "f32")])
def test_register_dispatch_matches_reference(scene, case, kind):
    """VGICP and NDT (P2D) through the method factory: the same iterations,
    correspondence counts and convergence; poses within POSE_ATOL_F64 in
    float64, in float32 within the reference's own float32 band."""
    (sx, sm, tx, tm), T_rel = scene
    kw = dict(REG_CASES[case], transformation_epsilon=REG_CASES[case].get("transformation_epsilon", 5e-4))
    rcfg, cfg = RefRegistrationConfig(**kw), RegistrationConfig(**kw)

    def run(k):
        (rsx, psx), (rtx, ptx) = _both(sx, k), _both(tx, k)
        (rsm, psm), (rtm, ptm) = _both(sm, k, True), _both(tm, k, True)
        eye = _both(np.eye(4), k)
        ref = ref_apdgicp.register_dispatch(ref_apdgicp.prepare(rsx, rsm, rcfg),
                                            ref_apdgicp.prepare(rtx, rtm, rcfg), eye[0], rcfg)
        got = apdgicp.register_dispatch(apdgicp.prepare(psx, psm, cfg, device=CPU),
                                        apdgicp.prepare(ptx, ptm, cfg, device=CPU), eye[1], cfg, device=CPU)
        return ref, got

    ref, got = run(kind)
    assert bool(got.converged) == bool(ref.converged)
    assert int(got.iterations) == int(ref.iterations)
    assert int(got.num_correspondences) == int(ref.num_correspondences) > 100
    if kind == "f64":
        np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=POSE_ATOL_F64)
        np.testing.assert_allclose(float(got.fitness), float(ref.fitness), rtol=1e-9)
    else:
        ref64 = np.asarray(run("f64")[0].T)
        err, ref_err = (np.abs(np.asarray(T, np.float64) - ref64).max() for T in (got.T.numpy(), ref.T))
        assert err <= 2.0 * ref_err + 1e-5, (err, ref_err)
    # and it aligns the scene (the reference's own bounds)
    delta = np.linalg.inv(got.T.numpy().astype(np.float64)) @ T_rel
    assert np.linalg.norm(delta[:3, 3]) < 0.6


@pytest.mark.parametrize("mode", ["P2D", "D2D"])
def test_register_ndt_matches_reference(scene, mode):
    """register_ndt in both modes, float64, batched over two problems (the
    port batches where the reference vmaps): each equals the reference's
    single problem."""
    (sx, sm, tx, tm), _ = scene
    rcfg = RefRegistrationConfig(transformation_epsilon=1e-2)
    cfg = RegistrationConfig(transformation_epsilon=1e-2)
    vm_r = ref_vgicp.build_voxel_map(jnp.asarray(tx), jnp.asarray(tm), rcfg)
    ref = ref_vgicp.register_ndt(jnp.asarray(sx), jnp.asarray(sm), vm_r, jnp.eye(4, dtype=jnp.float64), rcfg,
                                 mode=mode, src_capacity=512)
    two = lambda a: torch.as_tensor(a)[None].expand((2,) + a.shape).contiguous()  # noqa: E731
    vm = vgicp.build_voxel_map(two(tx), two(tm), cfg)
    got = vgicp.register_ndt(two(sx), two(sm), vm, two(np.eye(4)), cfg, mode=mode, src_capacity=512)
    for b in range(2):
        assert int(got.iterations[b]) == int(ref.iterations) and bool(got.converged[b])
        assert int(got.num_correspondences[b]) == int(ref.num_correspondences)
        np.testing.assert_allclose(got.T[b].numpy(), np.asarray(ref.T), rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(got.error[b]), float(ref.error), rtol=1e-9)


def _engine_cfg(mod, method):
    cfg = mod.get("cp")
    return dataclasses.replace(
        cfg,
        loop=dataclasses.replace(cfg.loop, enable=False),
        floor=dataclasses.replace(cfg.floor, floor_pts_thresh=12),
        registration=dataclasses.replace(cfg.registration, method=method),
    )


@pytest.mark.parametrize("method", ["VGICP", "NDT_OMP"])
def test_engine_with_voxel_method_matches_reference(method):
    """The Engine's odometry registering through VGICP / NDT over four
    frames of the engine course, float64, the JAX engine's draws injected:
    the same keyframes, poses within ENGINE_POSE_ATOL_F64."""
    from rivslam_tpu import presets as ref_presets
    from rivslam_tpu_torch import presets

    jax.config.update("jax_enable_x64", True)
    key, keys = jax.random.key(ENGINE_SEED), []
    for _ in range(COURSE["n_frames"]):
        key, k1 = jax.random.split(key)
        keys.append(k1)
    ref_eng = ref_pipeline.Engine(_engine_cfg(ref_presets, method), dtype=jnp.float64, seed=ENGINE_SEED)
    ref = ref_datasets.replay(ref_eng, ref_syn.simulate_sequence(**COURSE)[0], CAP, IMU_CAP)
    eng = pipeline.Engine(_engine_cfg(presets, method), dtype=torch.float64, seed=ENGINE_SEED, device=CPU,
                          uniforms=lambda i, shape: np.asarray(jax.random.uniform(keys[i], shape)))
    got = datasets.replay(eng, synthetic.simulate_sequence(**COURSE)[0], CAP, IMU_CAP)
    assert [o["is_keyframe"] for o in got] == [o["is_keyframe"] for o in ref]
    assert [o["registration_ok"] for o in got] == [o["registration_ok"] for o in ref]
    for k in ("pose", "odom"):
        np.testing.assert_allclose(np.stack([o[k] for o in got]), np.stack([o[k] for o in ref]),
                                   rtol=0, atol=ENGINE_POSE_ATOL_F64)
    assert [o["status"]["num_correspondences"] for o in got[1:]] == \
        [o["status"]["num_correspondences"] for o in ref[1:]]


@pytest.mark.parametrize("method", sorted(
    {"FAST_APDGICP", "APDGICP", "FAST_GICP", "GICP", "GICP_OMP", "ICP", "VGICP", "FAST_VGICP", "FAST_VGICP_CUDA",
     "NDT", "NDT_OMP", "NDT_CUDA"}))
def test_dispatch_takes_every_method_the_reference_takes(method):
    """register_dispatch raises for no method the reference's factory
    accepts: each registers a cloud onto itself at the identity."""
    rng = np.random.default_rng(3)
    xyz = torch.as_tensor(rng.normal(size=(96, 3)) * 5, dtype=torch.float32)
    mask = torch.ones(96, dtype=torch.bool)
    cfg = RegistrationConfig(method=method, transformation_epsilon=1e-2)
    prepared = apdgicp.prepare(xyz, mask, cfg, device=CPU)
    res = apdgicp.register_dispatch(prepared, prepared, torch.eye(4), cfg, device=CPU)
    assert int(res.num_correspondences) > 0
    np.testing.assert_allclose(res.T.numpy(), np.eye(4), atol=0.05)


def test_validation_course_cfg_matches_reference():
    """The port's validation harness builds the reference's configurations
    for every course, method and loop setting it is given."""
    for course in validation.COURSES:
        for method, loop_on, reg in (("FAST_APDGICP", True, None), ("VGICP", False, {"use_fast_path": False}),
                                     ("NDT_OMP", True, {"covariance_method": "RBF"})):
            got = validation.build_course_cfg(course, method, loop_on, reg)
            ref = ref_validation.build_course_cfg(course, method, loop_on, reg)
            assert dataclasses.asdict(got) == dataclasses.asdict(ref), (course, method)
    assert validation.COURSES == ref_validation.COURSES
    assert validation.PRESET_FOR_COURSE == ref_validation.PRESET_FOR_COURSE


def reference_voxel_course(method: str) -> dict:
    """The JAX engine over the cp validation course under the validation
    harness's configuration with ``method``, engine seed 0."""
    from test_torch_engine_loop import reference_course

    return reference_course(ref_validation.build_course_cfg("cp", method))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for m in ("VGICP", "NDT_OMP"):
        print(json.dumps({m: reference_voxel_course(m), "seed": ENGINE_SEED}), flush=True)
