"""The port's VGICP / NDT registration family on the CPU.

VGICP is held to the plain float64 reference ``benchmark/reference/vgicp.py``
(fast_gicp's ``FastVGICP``: the additive voxel map of the target's point
covariances, each term weighted by sqrt(N_v)): the voxel map, H, b and the
error at a pose, a registration's answer through ``register_dispatch`` and
the Engine's odometry, and the point-spread voxel, which fails them. The
JAX package builds NDT's voxel for VGICP and weights nothing (ROADMAP, F8),
so it holds only what VGICP and NDT still share: NDT's point-spread map
(``ops/voxel.gaussian_voxel_map``), the DIRECT1 / DIRECT7 and KDTREE voxel
correspondences, the unweighted LM from one given voxel map, the tiled
nearest neighbour (``ops/knn.nearest_neighbor_tiled``), ``register_ndt``
(P2D and D2D) through ``register_dispatch``, and the Engine with
``method="NDT_OMP"``.

The registration scene is the reference's tests/test_vgicp.py scene at 512
points: one simulated world, the target at 2 m height and the source 0.36 m
and 1.7 deg off it.

Run as a script (``PYTHONPATH=.:tests python tests/test_torch_vgicp.py``,
about 4 minutes), it prints the JAX engine's figures on chip_smoke.py's
voxel runs: the "cp" validation course (120 frames at capacity 1024,
float32 on the CPU, engine seed 0) under the validation harness's
configuration with ``method="VGICP"`` and ``method="NDT_OMP"``:
full-trajectory ATE (loop-corrected and the window backend's own),
keyframes and loops closed. chip_smoke.py holds the port's NDT_OMP card run
to them; its VGICP card run it holds to the port's own CPU run
(``PYTHONPATH=.:tests python tests/test_torch_engine_loop.py --port vgicp0``),
since the JAX engine's VGICP is not fast_gicp's. The runs are also written
frame by frame to ``tests/torch_ref/cp_f32.npz`` (as "vgicp0" and "ndt0";
tests/test_torch_engine_loop.py's script mode).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

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
from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.eval import validation
from rivslam_tpu_torch.frontend import apdgicp, vgicp
from rivslam_tpu_torch.io import datasets, synthetic
from rivslam_tpu_torch.ops import knn, nn_argmin, voxel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.reference import vgicp as plain  # noqa: E402

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
# a reported error against the plain reference's error at the answer
ERROR_RTOL = {"f64": 1e-9, "f32": 1e-4}


def _hold_to_plain(source, target, res, cfg, kind):
    """A VGICP answer (DIRECT1) against ``benchmark/reference/vgicp.py`` in
    float64 on the registration's own prepared clouds: its reported error
    is the error at its answer, and one Gauss-Newton step from its answer
    is under the configuration's stopping rule."""
    b = (lambda t: t[None]) if res.T.ndim == 2 else (lambda t: t)
    problem = plain.Problem(*(b(getattr(c, f)) for c in (source, target) for f in ("xyz", "mask", "cov")), cfg)
    T = b(res.T).double()
    np.testing.assert_allclose(b(res.error).double().numpy(), problem.error(T).numpy(), rtol=ERROR_RTOL[kind])
    steps = problem.step_units(T)
    assert bool((steps < 1.0).all()), steps


# KDTREE's nearest-7 cut is the one float32 case that flips voxels: held in float64
@pytest.mark.parametrize("case,kind", [(c, k) for c in REG_CASES for k in ("f64", "f32")
                                       if (c, k) != ("FAST_VGICP_CUDA KDTREE", "f32")])
def test_register_dispatch_matches_reference(scene, case, kind):
    """VGICP and NDT (P2D) through the method factory. NDT against the JAX
    package: the same iterations, correspondence counts and convergence;
    poses within POSE_ATOL_F64 in float64, in float32 within the
    reference's own float32 band. VGICP (DIRECT1) against the plain
    reference (``_hold_to_plain``). The KDTREE search, which the plain
    reference does not model, holds to JAX over what the two still share:
    the unweighted LM from JAX's own voxel map, as NDT runs it."""
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

    if case == "VGICP":
        (psx, ptx), (psm, ptm) = (_both(a, kind)[1] for a in (sx, tx)), (torch.as_tensor(sm), torch.as_tensor(tm))
        source, target = (apdgicp.prepare(x, m, cfg, device=CPU) for x, m in ((psx, psm), (ptx, ptm)))
        got = apdgicp.register_dispatch(source, target, torch.eye(4, dtype=psx.dtype), cfg, device=CPU)
        assert bool(got.converged) and int(got.num_correspondences) > 100
        _hold_to_plain(source, target, got, cfg, kind)
    elif case == "FAST_VGICP_CUDA KDTREE":
        src_r = ref_apdgicp.prepare(jnp.asarray(sx), jnp.asarray(sm), rcfg)
        vm_r = ref_vgicp.build_voxel_map(jnp.asarray(tx), jnp.asarray(tm), rcfg)
        ref = ref_vgicp.register_vgicp(src_r, vm_r, jnp.eye(4, dtype=jnp.float64), rcfg)
        src = apdgicp.PreparedCloud(*(torch.as_tensor(np.asarray(a))[None] for a in (src_r.xyz, src_r.mask, src_r.cov)))
        vm = vgicp.VoxelMap(*(torch.as_tensor(np.asarray(getattr(vm_r, f)))[None]
                              for f in ("coords", "mean", "cov", "count")))
        shared = apdgicp._map(vgicp.register_vgicp(src, vm, torch.eye(4, dtype=torch.float64)[None], cfg,
                                                   weighted=False), lambda t: t[0])
        assert (bool(shared.converged), int(shared.iterations), int(shared.num_correspondences)) == \
            (bool(ref.converged), int(ref.iterations), int(ref.num_correspondences))
        np.testing.assert_allclose(shared.T.numpy(), np.asarray(ref.T), rtol=0, atol=POSE_ATOL_F64)
        got = run(kind)[1]  # the method itself, through the factory
        assert bool(got.converged) and int(got.num_correspondences) > 100
    else:
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


def _voxel_scene(seed: int = 5, n: int = 256):
    """A sparse cloud as a radar scan voxelizes at 1 m: 60 distinct voxels
    of 1-5 points each, padded to ``n``, and a random SPD covariance a
    point (float64)."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(12 * 12 * 4, 60, replace=False)
    ijk = np.stack(np.unravel_index(cells, (12, 12, 4)), -1) - np.array([6, 6, 2])
    counts = rng.integers(1, 6, 60)
    pts = np.concatenate([c + rng.uniform(0.05, 0.95, (k, 3)) for c, k in zip(ijk, counts)])
    xyz = np.zeros((n, 3))
    xyz[:len(pts)] = pts
    mask = np.arange(n) < len(pts)
    A = rng.normal(size=(n, 3, 3)) * 0.3
    cov = A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(3)
    return torch.as_tensor(xyz), torch.as_tensor(mask), torch.as_tensor(cov), counts


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_additive_voxel_map_equals_plain_reference(kind):
    """VGICP's map from the points' covariances: every voxel's mean and
    covariance, the average of its points' (not regularized again), and
    its count, as the plain reference's (float64 to 1e-12; float32 to its
    rounding); batched, each problem's map is the single problem's."""
    xyz, mask, cov, counts = _voxel_scene()
    dt = DTYPES[kind][0]
    cfg = RegistrationConfig(method="FAST_VGICP")
    vm = vgicp.build_voxel_map(xyz.to(dt), mask, cfg, capacity=256, cov=cov.to(dt))
    assert int(vm.valid.sum()) == len(counts) and sorted(vm.count[vm.valid].tolist()) == sorted(counts.tolist())
    ref = plain.build_map(xyz[None], mask[None], cov[None], cfg.voxel_resolution)
    gaps = plain.map_gaps(vm.coords[None], vm.mean[None], vm.cov[None], vm.count[None], ref, cfg.voxel_resolution)
    assert len(gaps) == len(counts) and float(gaps.max()) < (1e-12 if kind == "f64" else 1e-5), gaps.max()
    two = vgicp.build_voxel_map(torch.stack([xyz, xyz.flip(0)]).to(dt), torch.stack([mask, mask.flip(0)]), cfg,
                                capacity=256, cov=torch.stack([cov, cov.flip(0)]).to(dt))
    for f in ("coords", "count"):
        np.testing.assert_array_equal(getattr(two, f)[0].numpy(), getattr(vm, f).numpy())
    np.testing.assert_allclose(two.cov[1][two.valid[1]].numpy(), vm.cov[vm.valid].numpy(), rtol=1e-5)


def _pair(seed: int = 6):
    """A source and a target cloud of ``_voxel_scene``'s kind, the source
    moved 0.12 m and 1.1 deg off, each point's covariance from the port's
    prepare (RBF, PLANE), float64."""
    xyz, mask, _, _ = _voxel_scene(seed)
    cfg = RegistrationConfig(method="FAST_VGICP", covariance_method="RBF", rbf_kernel_width=4.0)
    T_rel = lie.se3_exp(torch.tensor([0.0, 0.01, 0.02, 0.1, -0.06, 0.02], dtype=torch.float64))
    rng = np.random.default_rng(seed + 1)
    src_xyz = (xyz - T_rel[:3, 3]) @ T_rel[:3, :3] + torch.as_tensor(rng.normal(size=xyz.shape) * 0.01)
    src_xyz = torch.where(mask[:, None], src_xyz, 0.0)
    source, target = (apdgicp.prepare(x[None], mask[None], cfg, device=CPU) for x in (src_xyz, xyz))
    return source, target, cfg


def test_weighted_normal_equations_equal_plain_reference():
    """At a pose off the answer: the port's DIRECT1 correspondences over
    the additive map give the plain reference's H, b and error, each term
    weighted by sqrt(N_v)."""
    source, target, cfg = _pair()
    vm = vgicp.build_voxel_map(target.xyz, target.mask, cfg, capacity=256, cov=target.cov)
    T = lie.se3_exp(torch.tensor([0.005, -0.01, 0.01, 0.05, 0.03, -0.02], dtype=torch.float64))[None]
    linearize_at, error_at, final_at = vgicp.MODELS["DIRECT1"](
        source.xyz, source.mask, source.cov, vm.coords, vm.mean, vm.cov, vm.count, cfg)
    H, b, err, corr = linearize_at(T)
    problem = plain.Problem(source.xyz, source.mask, source.cov, target.xyz, target.mask, target.cov, cfg)
    H_r, b_r = problem.normal_equations(T)
    assert int(corr[1].sum()) > 50
    np.testing.assert_allclose(H.numpy(), H_r.numpy(), rtol=1e-10, atol=1e-9 * float(H_r.abs().max()))
    np.testing.assert_allclose(b.numpy(), b_r.numpy(), rtol=1e-10, atol=1e-9 * float(b_r.abs().max()))
    np.testing.assert_allclose(err.numpy(), problem.error(T).numpy(), rtol=1e-12)
    np.testing.assert_allclose(error_at(T, corr).numpy(), err.numpy(), rtol=1e-12)
    np.testing.assert_allclose(final_at(T)[0].numpy(), err.numpy(), rtol=1e-12)


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_registration_answer_holds_to_plain_reference(kind):
    """FAST_VGICP through ``register_dispatch`` from the identity: it
    converges, its reported error is the plain reference's error at its
    answer, and one Gauss-Newton step from there is under the rule."""
    source, target, cfg = _pair()
    dt = DTYPES[kind][0]
    source, target = (apdgicp._map(c, lambda t: t.to(dt) if t.is_floating_point() else t) for c in (source, target))
    res = apdgicp.register_dispatch(source, target, torch.eye(4, dtype=dt)[None], cfg, device=CPU)
    assert bool(res.converged.all()) and int(res.num_correspondences.min()) > 50
    _hold_to_plain(source, target, res, cfg, kind)


def test_point_spread_voxel_fails_the_plain_reference():
    """NDT's voxel, the point spread with its eigenvalues clamped (what the
    port built for VGICP before, and the JAX package still builds), is not
    fast_gicp's: its covariances miss the plain reference's by far, and so
    do the error and H at a pose; without sqrt(N_v) the error misses too."""
    source, target, cfg = _pair()
    T = torch.eye(4, dtype=torch.float64)[None]
    problem = plain.Problem(source.xyz, source.mask, source.cov, target.xyz, target.mask, target.cov, cfg)
    spread = vgicp.build_voxel_map(target.xyz, target.mask, cfg, capacity=256)
    gaps = plain.map_gaps(spread.coords, spread.mean, spread.cov, spread.count, problem.map, cfg.voxel_resolution)
    assert float(gaps.median()) > 0.1, gaps.median()
    additive = vgicp.build_voxel_map(target.xyz, target.mask, cfg, capacity=256, cov=target.cov)
    for vm, models in ((spread, vgicp.MODELS), (additive, vgicp.NDT_MODELS)):
        H, _, err, _ = models["DIRECT1"](source.xyz, source.mask, source.cov, vm.coords, vm.mean, vm.cov, vm.count,
                                         cfg)[0](T)
        assert abs(float(err[0]) / float(problem.error(T)[0]) - 1.0) > 0.05
    H_r, _ = problem.normal_equations(T)
    assert float((H - H_r).abs().max()) > 0.05 * float(H_r.abs().max())


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
def test_engine_with_voxel_method_matches_reference(method, monkeypatch):
    """The Engine's odometry registering through VGICP / NDT over four
    frames of the engine course, float64. NDT_OMP against the JAX engine,
    its draws injected: the same keyframes, poses within
    ENGINE_POSE_ATOL_F64. VGICP against the plain reference: each frame's
    registration, as the odometry calls ``register_dispatch``, builds the
    additive map from the target's covariances, and its answer holds
    (``_hold_to_plain``)."""
    from rivslam_tpu import presets as ref_presets
    from rivslam_tpu_torch import presets

    if method == "VGICP":
        calls, maps = [], []
        inner, inner_map = apdgicp.register_dispatch, vgicp.build_voxel_map

        def register_dispatch(source, target, guess, cfg, *args, **kwargs):
            res = inner(source, target, guess, cfg, *args, **kwargs)
            if source.xyz.ndim == 3:  # the batched call does the work
                calls.append((source, target, res, cfg))
            return res

        def build_voxel_map(*args, **kwargs):
            maps.append(kwargs.get("cov"))
            return inner_map(*args, **kwargs)

        monkeypatch.setattr(apdgicp, "register_dispatch", register_dispatch)
        monkeypatch.setattr(vgicp, "build_voxel_map", build_voxel_map)
        eng = pipeline.Engine(_engine_cfg(presets, method), dtype=torch.float64, seed=ENGINE_SEED, device=CPU)
        got = datasets.replay(eng, synthetic.simulate_sequence(**COURSE)[0], CAP, IMU_CAP)
        assert len(calls) == COURSE["n_frames"] - 1 == len(maps)
        for (source, target, res, cfg), cov in zip(calls, maps):
            assert cov is target.cov
            _hold_to_plain(source, target, res, cfg, "f64")
        assert all(o["registration_ok"] for o in got)
        return
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
    harness's configuration with ``method``, engine seed 0; the run is saved
    to test_torch_engine_loop.REF_NPZ as "vgicp0" / "ndt0"."""
    from test_torch_engine_loop import reference_course

    name = {"VGICP": "vgicp", "NDT_OMP": "ndt"}[method] + str(ENGINE_SEED)
    return reference_course(ref_validation.build_course_cfg("cp", method), ENGINE_SEED, name)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for m in ("VGICP", "NDT_OMP"):
        print(json.dumps({m: reference_voxel_course(m), "seed": ENGINE_SEED}), flush=True)
