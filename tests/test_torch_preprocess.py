"""The port's per-frame preprocessing against the JAX package on the CPU:
filters, voxel downsample, deskew, REVE and floor detection with the same
RANSAC draws injected, knn, radius_count and the [..., 3, 3] eig3 forms.
Inputs are numpy arrays from fixed seeds (a radar-realistic simulated
scan), fed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shared_cache  # noqa: F401  (one torch thread per test process)

from rivslam_tpu.core import config as ref_config
from rivslam_tpu.core.pointcloud import RadarCloud as RefCloud
from rivslam_tpu.frontend import floor as ref_floor
from rivslam_tpu.frontend import reve as ref_reve
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu.ops import deskew as ref_deskew
from rivslam_tpu.ops import eig3 as ref_eig3
from rivslam_tpu.ops import filters as ref_filters
from rivslam_tpu.ops import knn as ref_knn
from rivslam_tpu.ops import voxel as ref_voxel
from rivslam_tpu_torch.core import config
from rivslam_tpu_torch.core.pointcloud import RadarCloud
from rivslam_tpu_torch.frontend import floor, reve
from rivslam_tpu_torch.ops import deskew, eig3, filters, knn, voxel

CAP = 512
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module")
def frame():
    """One radar frame of the simulator, with NaN and weak returns added."""
    seq, _ = ref_syn.simulate_sequence(seed=3, n_frames=3, capacity=CAP - 24)
    f = seq.frame(2)
    rng = np.random.default_rng(0)
    xyz = np.concatenate([f["xyz"], rng.normal(size=(24, 3)) * 5])
    xyz[-3:, 1] = np.nan
    inten = np.concatenate([f["intensity"], rng.uniform(-5, 5, 24)])
    dop = np.concatenate([f["doppler"], rng.normal(size=24)])
    return xyz, dop, inten


def _clouds(frame, kind="f32"):
    jdt, tdt = DTYPES[kind]
    xyz, dop, inten = frame
    ref = RefCloud.from_numpy(xyz, CAP, doppler=dop, intensity=inten, dtype=jdt)
    got = RadarCloud.from_numpy(xyz, CAP, doppler=dop, intensity=inten, dtype=tdt, device="cpu")
    return ref, got


def _assert_cloud(got, ref, atol):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    m = np.asarray(ref.mask)
    for f in ("xyz", "doppler", "intensity"):
        np.testing.assert_allclose(getattr(got, f).numpy()[m], np.asarray(getattr(ref, f))[m],
                                   rtol=0, atol=atol)


PRE = config.PreprocessConfig()
REF_PRE = ref_config.PreprocessConfig()


@pytest.mark.parametrize(
    "name",
    ["nan", "power", "distance", "radius", "statistical", "bilateral"],
)
def test_filters_match_reference(frame, name):
    """Masks equal; the bilateral filter's intensities to float32 rounding."""
    ref, got = _clouds(frame)
    ref, got = ref_filters.nan_filter(ref), filters.nan_filter(got)
    if name == "power":
        ref, got = ref_filters.power_filter(ref, 5.0), filters.power_filter(got, 5.0)
    elif name == "distance":
        pre = dataclasses.replace(PRE, z_low_thresh=-3.0, z_high_thresh=5.0)
        ref_pre = dataclasses.replace(REF_PRE, z_low_thresh=-3.0, z_high_thresh=5.0)
        ref, got = ref_filters.distance_filter(ref, ref_pre), filters.distance_filter(got, pre)
    elif name == "radius":
        ref = ref_filters.radius_outlier_removal(ref, 1.0, 2)
        got = filters.radius_outlier_removal(got, 1.0, 2)
    elif name == "statistical":
        ref = ref_filters.statistical_outlier_removal(ref, 8, 1.0)
        got = filters.statistical_outlier_removal(got, 8, 1.0)
    elif name == "bilateral":
        ref = ref_filters.bilateral_filter(ref, 5.0, 3.0)
        got = filters.bilateral_filter(got, 5.0, 3.0)
    assert 0 < int(got.mask.sum()) <= CAP - 3
    _assert_cloud(got, ref, atol=1e-4)


# voxel centroids: the reference scatter-adds in sorted order, the port's
# segment_reduce sums each voxel in the same order; float32 rounding at 60 m
@pytest.mark.parametrize("resolution", [0.1, 1.0])
def test_voxel_downsample_matches_reference(frame, resolution):
    ref, got = _clouds(frame)
    ref, got = ref_filters.nan_filter(ref), filters.nan_filter(got)
    r = ref_voxel.voxel_downsample(ref, resolution, CAP)
    g = voxel.voxel_downsample(got, resolution, CAP)
    if resolution == 1.0:
        assert int(g.mask.sum()) < int(got.mask.sum())  # voxels really merge
    _assert_cloud(g, r, atol=1e-5)


def test_voxel_downsample_drops_overflow_voxels(frame):
    ref, got = _clouds(frame)
    ref, got = ref_filters.nan_filter(ref), filters.nan_filter(got)
    r = ref_voxel.voxel_downsample(ref, 0.1, 100)
    g = voxel.voxel_downsample(got, 0.1, 100)
    assert g.xyz.shape == (100, 3) and bool(g.mask.all())
    _assert_cloud(g, r, atol=1e-5)


def test_deskew_matches_reference(frame):
    ref, got = _clouds(frame, "f64")
    w = np.array([0.05, -0.1, 0.6])
    r = ref_deskew.deskew(ref_filters.nan_filter(ref), jnp.asarray(w), scan_period=0.0833)
    g = deskew.deskew(filters.nan_filter(got), torch.tensor(w), scan_period=0.0833)
    _assert_cloud(g, r, atol=1e-9)


@pytest.mark.parametrize("kind,atol", [("f32", 1e-4), ("f64", 1e-9)])
def test_reve_matches_reference_with_injected_draws(frame, kind, atol):
    """The port takes the reference's own uniform draws, so both test the
    same RANSAC hypotheses. (A NaN point poisons the normal equations of
    both packages alike, so this scan has none.)"""
    xyz, dop, inten = frame
    ref, got = _clouds((np.nan_to_num(xyz), dop, inten), kind)
    ref, got = ref_filters.nan_filter(ref), filters.nan_filter(got)
    cfg, ref_cfg = config.ReveConfig(), ref_config.ReveConfig()
    key = jax.random.key(7)
    r = ref_reve.estimate_ego_velocity(ref, ref_cfg, key)
    u = np.asarray(jax.random.uniform(key, (ref_cfg.ransac_iter, CAP)))
    g = reve.estimate_ego_velocity(got, cfg, torch.tensor(u))
    assert bool(g.success) == bool(r.success) and bool(g.success)
    assert bool(g.zero_velocity) == bool(r.zero_velocity)
    np.testing.assert_array_equal(g.inlier_mask.numpy(), np.asarray(r.inlier_mask))
    np.testing.assert_allclose(g.v.numpy(), np.asarray(r.v), rtol=0, atol=atol)
    np.testing.assert_allclose(g.sigma.numpy(), np.asarray(r.sigma), rtol=1e-3, atol=atol)


def test_reve_zero_velocity_gate():
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(200, 3)) * 10 + [20, 0, 0]
    dop = rng.normal(size=200) * 0.005
    ref = RefCloud.from_numpy(xyz, 256, doppler=dop, intensity=np.full(200, 20.0))
    got = RadarCloud.from_numpy(xyz, 256, doppler=dop, intensity=np.full(200, 20.0), device="cpu")
    key = jax.random.key(0)
    r = ref_reve.estimate_ego_velocity(ref, ref_config.ReveConfig(), key)
    u = np.asarray(jax.random.uniform(key, (ref_config.ReveConfig().ransac_iter, 256)))
    g = reve.estimate_ego_velocity(got, config.ReveConfig(), torch.tensor(u))
    assert bool(g.zero_velocity) and bool(r.zero_velocity)
    np.testing.assert_array_equal(g.v.numpy(), np.asarray(r.v))
    np.testing.assert_array_equal(g.inlier_mask.numpy(), np.asarray(r.inlier_mask))


def _floor_scene(rng):
    """tests/test_floor.py's scene: ground 2 m below the sensor + clutter."""
    ground = np.stack([rng.uniform(-20, 20, 300), rng.uniform(-20, 20, 300),
                       np.full(300, -2.0) + rng.normal(size=300) * 0.02], axis=1)
    other = np.stack([rng.uniform(-20, 20, 200), rng.uniform(-20, 20, 200),
                      rng.uniform(-0.5, 3.0, 200)], axis=1)
    return np.concatenate([ground, other, np.zeros((12, 3))]), np.arange(512) < 500


@pytest.mark.parametrize("scene", ["ground", "scan", "tilted"])
def test_floor_matches_reference_with_injected_draws(frame, scene):
    rng = np.random.default_rng(5)
    cfg, ref_cfg = config.FloorConfig(), ref_config.FloorConfig()
    if scene == "scan":
        xyz, mask = np.nan_to_num(frame[0]), np.isfinite(frame[0]).all(1)
    else:
        xyz, mask = _floor_scene(rng)
        if scene == "tilted":
            cfg, ref_cfg = (dataclasses.replace(c, tilt_deg=3.0) for c in (cfg, ref_cfg))
    key = jax.random.key(11)
    r = ref_floor.detect_floor(jnp.asarray(xyz, jnp.float32), jnp.asarray(mask), ref_cfg, key)
    u = np.asarray(jax.random.uniform(key, (ref_cfg.ransac_iterations, len(xyz))))
    g = floor.detect_floor(torch.tensor(xyz, dtype=torch.float32), torch.tensor(mask), cfg,
                           torch.tensor(u))
    assert bool(g.found) == bool(r.found)
    assert int(g.num_inliers) == int(r.num_inliers)
    np.testing.assert_allclose(g.coeffs.numpy(), np.asarray(r.coeffs), rtol=0, atol=1e-4)
    if scene == "ground":
        assert bool(g.found) and abs(float(g.coeffs[3]) - 2.0) < 0.05


def test_knn_and_radius_count_match_reference():
    """Exact duplicates check the order among equal distances (lower index
    first, as lax.top_k)."""
    rng = np.random.default_rng(6)
    pts = (rng.normal(size=(2, 300, 3)) * 3).astype(np.float32)
    pts[:, 200:240] = pts[:, :40]
    mask = rng.uniform(size=(2, 300)) > 0.1
    idx_w, d2_w = ref_knn.knn(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), 10)
    idx, d2 = knn.knn(torch.tensor(pts), torch.tensor(pts), torch.tensor(mask), 10)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_w), rtol=1e-5, atol=1e-4)
    for radius in (0.5, 1.5):
        np.testing.assert_array_equal(
            knn.radius_count(torch.tensor(pts), torch.tensor(mask), radius).numpy(),
            np.asarray(ref_knn.radius_count(jnp.asarray(pts), jnp.asarray(mask), radius)),
        )


def _near_degenerate_covs():
    """Planar, linear, isotropic, zero and nearly equal spectra in random
    orientations, plus random PSD matrices (float64)."""
    rng = np.random.default_rng(8)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 3, 3)))
    spectra = [[1.0, 0.5, 1e-6], [1.0, 1e-6, 1e-6], [2.0, 2.0, 2.0], [0.0, 0.0, 0.0],
               [1.0, 1.0, 1.0 - 1e-7], [1e-3, 1e-3, 1e-9]]
    C = np.stack([q @ np.diag(s) @ q.T for q, s in zip(Q, spectra)])
    A = rng.normal(size=(40, 3, 3))
    return np.concatenate([C, A @ np.swapaxes(A, 1, 2)])


def test_eig3_matrix_forms_match_reference():
    C = _near_degenerate_covs()
    np.testing.assert_allclose(
        eig3.eigenvalues_sym3(torch.tensor(C)).numpy(),
        np.asarray(ref_eig3.eigenvalues_sym3(jnp.asarray(C))), rtol=0, atol=1e-9,
    )
    np.testing.assert_allclose(
        eig3.smallest_eigenvector_sym3(torch.tensor(C)).numpy(),
        np.asarray(ref_eig3.smallest_eigenvector_sym3(jnp.asarray(C))), rtol=0, atol=1e-6,
    )
