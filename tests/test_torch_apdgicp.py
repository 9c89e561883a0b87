"""The port's scan match (prepare + register_fast) against the JAX package on
the CPU, and the reference's forward/backward acceptance on the port.

Inputs are the bench protocol's frame pairs and the entry() example, made
with numpy and fed to both packages. Where the reference's K1 path runs, it
runs the Pallas kernel in interpret mode, as on any non-TPU backend."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

import rivslam_tpu_torch
from rivslam_tpu.core.config import RegistrationConfig as RefConfig
from rivslam_tpu.frontend import apdgicp as ref_apdgicp
from rivslam_tpu_torch import convert
from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp
from rivslam_tpu_torch.io import synthetic

CPU = "cpu"
CAPACITY = 256
# registration parity: the two packages sum H/b in different orders, so T
# agrees to float32 round-off amplified by the LM solve (the bound of
# tests/test_pallas_nn.py's flag-on/off parity)
T_ATOL = 1e-3


@pytest.fixture(scope="module")
def pairs():
    """bench.py's protocol at a small size: 4 consecutive pairs, capacity 256."""
    src_xyz, src_mask, tgt_xyz, tgt_mask, rel = synthetic.load_pairs(4, CAPACITY, device=CPU)
    return [t.numpy() for t in (src_xyz, src_mask, tgt_xyz, tgt_mask)], rel


def _ref_cfg(cfg: RegistrationConfig) -> RefConfig:
    return RefConfig(**dataclasses.asdict(cfg))


def _plane_gap(xyz, mask, cfg):
    """Float64 numpy recomputation of each neighbourhood's covariance
    (before regularization): the gap between its two smallest eigenvalues.
    Where it is ~0 (a lone point: every other RBF weight vanishes) the plane
    normal is rounding noise in any implementation."""
    x = xyz.astype(np.float64)
    sent = np.where(mask[:, None], x, 1e6)
    d2 = ((sent[:, None, :] - sent[None, :, :]) ** 2).sum(-1)
    if cfg.covariance_method == "KNN":
        kth = np.sort(d2, axis=1)[:, cfg.k_correspondences - 1]
        W = ((d2 <= kth[:, None]) & mask[None, :]).astype(np.float64)
    else:
        W = np.exp(-cfg.rbf_kernel_width * d2) * ((d2 <= cfg.rbf_max_dist**2) & mask[None, :])
    cnt = W.sum(1)
    mean = W @ x / cnt[:, None]
    C = np.einsum("nm,mi,mj->nij", W, x, x) / cnt[:, None, None] - mean[:, :, None] * mean[:, None, :]
    lam = np.linalg.eigvalsh(C)
    return lam[:, 1] - lam[:, 0]


def _defined(xyz, mask, cfg):
    """Valid rows whose neighbourhood defines a plane (gap > 1e-6); at least
    80% of the valid rows, so the comparison is never vacuous."""
    defined = mask & np.stack([_plane_gap(xyz[b], mask[b], cfg) > 1e-6 for b in range(len(xyz))])
    assert defined.sum() >= 0.8 * mask.sum()
    return defined


def _prepare_both(xyz, mask, cfg):
    want = jax.jit(jax.vmap(lambda x, m: ref_apdgicp.prepare(x, m, _ref_cfg(cfg)).cov))(
        jnp.asarray(xyz), jnp.asarray(mask)
    )
    got = apdgicp.prepare(xyz, mask, cfg, device=CPU).cov
    assert got.shape == xyz.shape + (3,) and got.numpy().dtype == xyz.dtype
    return got.numpy(), np.asarray(want)


COV_CASES = [("KNN", 0.25), ("RBF", 0.25), ("RBF", 4.0)]  # bare config; presets' RBF


@pytest.mark.parametrize("method,kernel_width", COV_CASES)
def test_prepare_covariances_match_reference(pairs, method, kernel_width):
    """Float64 through both packages: the same k-th-neighbour threshold
    (exact on both sides), moments and closed-form PLANE regularization.
    Held to 1e-6 wherever the neighbourhood defines a plane (gap > 1e-6)."""
    (src_xyz, src_mask, _, _), _ = pairs
    xyz = src_xyz.astype(np.float64)
    cfg = RegistrationConfig(covariance_method=method, rbf_kernel_width=kernel_width)
    got, want = _prepare_both(xyz, src_mask, cfg)
    defined = _defined(xyz, src_mask, cfg)
    np.testing.assert_allclose(got[defined], want[defined], rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["KNN", "RBF"])
def test_prepare_covariances_float32(pairs, method):
    """The working type. E[xx^T] - mean mean^T cancels at 30 m range
    (float32 moment error ~6e-8 |x|^2 ~ 5e-5), and each package rounds
    differently, so the plane normals agree to that error over the
    neighbourhood's eigenvalue gap: 2e-3 at the bare config's widths, on
    the rows that define a plane."""
    (src_xyz, src_mask, _, _), _ = pairs
    cfg = RegistrationConfig(covariance_method=method)
    got, want = _prepare_both(src_xyz, src_mask, cfg)
    defined = _defined(src_xyz, src_mask, cfg)
    np.testing.assert_allclose(got[defined], want[defined], rtol=0, atol=2e-3)


@pytest.mark.parametrize("flag", [False, True])
def test_entry_scan_match_matches_reference(flag):
    fn, args = rivslam_tpu_torch.entry(device=CPU)
    cfg = RegistrationConfig(use_pallas_correspondence=flag)
    np_args = [a.numpy() for a in args]
    want = jax.jit(
        lambda *a: ref_apdgicp.prepare_and_register(*a, _ref_cfg(cfg))
    )(*map(jnp.asarray, np_args))
    got = apdgicp.prepare_and_register(*np_args, cfg, device=CPU)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=0, atol=T_ATOL)
    assert int(got.num_correspondences) == int(want.num_correspondences)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    if flag:  # entry() itself is this configuration
        res = fn(*args)
        np.testing.assert_allclose(res.T.numpy(), got.T.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("optimizer", ["LM", "GN"])
def test_batched_register_matches_vmapped_reference(pairs, optimizer):
    """B=4 problems in one batched LM/GN loop against jax.vmap of the
    reference: per-problem iterations and convergence are equal."""
    (src_xyz, src_mask, tgt_xyz, tgt_mask), rel = pairs
    cfg = RegistrationConfig(optimizer=optimizer)
    guess = np.broadcast_to(np.eye(4, dtype=np.float32), (4, 4, 4)).copy()
    want = jax.jit(jax.vmap(
        lambda a, b, c, d, e: ref_apdgicp.prepare_and_register(a, b, c, d, e, _ref_cfg(cfg))
    ))(*map(jnp.asarray, (src_xyz, src_mask, tgt_xyz, tgt_mask, guess)))
    got = apdgicp.prepare_and_register(
        src_xyz, src_mask, tgt_xyz, tgt_mask, convert.guess(guess, device=CPU), cfg, device=CPU
    )
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_array_equal(
        got.num_correspondences.numpy(), np.asarray(want.num_correspondences)
    )
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(
        got.fitness.numpy(), np.asarray(want.fitness), rtol=1e-3, atol=1e-5
    )
    assert got.H.shape == (4, 6, 6) and got.error.shape == (4,)
    # and the protocol's ground truth is recovered (bench.py's sanity bound)
    terr = np.linalg.norm(got.T.numpy()[:, :3, 3] - rel[:, :3, 3], axis=1)
    assert np.median(terr) < 0.1


# ---- acceptance on the port alone: tests/test_apdgicp.py's forward/backward
# pattern with the reference's 0.05 m / 1 deg tolerance (gicp_test.cpp:148)

XI = np.array([0.01, 0.02, 0.05, 0.4, -0.25, 0.05])


@pytest.fixture(scope="module")
def omni_scene():
    """tests/test_apdgicp.py's dense omnidirectional scene (capacity 768:
    at 512 points the reference itself misses 0.05 m backward, by 3 mm)."""
    rng = np.random.default_rng(42)
    world = synthetic.make_world(rng, n_points=6000)
    T0 = np.eye(4)
    T0[:3, 3] = [0.0, 0.0, 2.0]
    T_rel = lie.se3_exp(torch.tensor(XI)).numpy()
    target = synthetic.observe(world, T0, rng, capacity=768, noise=0.01, device=CPU)
    source = synthetic.observe(world, T0 @ T_rel, rng, capacity=768, noise=0.01, device=CPU)
    return source, target, T_rel


def check_alignment(T_est, T_true, atol_t=0.05, atol_r_deg=1.0):
    delta = lie.se3_inverse(torch.tensor(T_est, dtype=torch.float64)) @ torch.tensor(T_true)
    dt = float(torch.linalg.norm(delta[:3, 3]))
    dr = float(lie.rotation_angle(delta[:3, :3])) * 180 / np.pi
    assert dt < atol_t, f"translation error {dt:.4f} m"
    assert dr < atol_r_deg, f"rotation error {dr:.3f} deg"


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_alignment_acceptance(omni_scene, direction, flag):
    source, target, T_rel = omni_scene
    cfg = RegistrationConfig(
        method="FAST_GICP", transformation_epsilon=5e-4, use_pallas_correspondence=flag
    )
    if direction == "backward":
        source, target, T_rel = target, source, np.linalg.inv(T_rel)
    res = apdgicp.prepare_and_register(
        source.xyz, source.mask, target.xyz, target.mask, torch.eye(4), cfg, device=CPU
    )
    assert bool(res.converged)
    check_alignment(res.T.numpy(), T_rel)


@pytest.mark.parametrize(
    "cfg",
    [RegistrationConfig(method="ICP"), RegistrationConfig(method="VGICP"),
     RegistrationConfig(use_fast_path=False)],
    ids=["ICP", "VGICP", "exact"],
)
def test_unported_paths_raise(cfg):
    """What earlier slices refused now runs: ICP and the exact path
    (use_fast_path=False) run the exact covariances and registration
    (tests/test_torch_exact.py holds them against the reference), VGICP the
    voxel registration (tests/test_torch_vgicp.py). A cloud registered onto
    itself stays at the identity."""
    rng = np.random.default_rng(3)
    xyz = torch.as_tensor(rng.normal(size=(64, 3)) * 5, dtype=torch.float32)
    mask = torch.ones(64, dtype=torch.bool)
    prepared = apdgicp.prepare(xyz, mask, cfg, device=CPU)
    res = apdgicp.register_dispatch(prepared, prepared, torch.eye(4), cfg, device=CPU)
    # VGICP: every point meets its own voxel (DIRECT1), whose mean is not the point
    assert bool(res.converged) and int(res.num_correspondences) == 64
    np.testing.assert_allclose(res.T.numpy(), np.eye(4), atol=1e-3 if cfg.method == "VGICP" else 1e-4)
