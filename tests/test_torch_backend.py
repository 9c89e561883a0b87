"""The port's window backend against the JAX package on the CPU: IMU
preintegration, the factor residuals, robust kernels, the edge information
(with K3's plain twin inside the fitness), the window LM/GN solve with and
without Schur elimination, and backend_step over a few frames. Inputs are
numpy arrays from fixed seeds, fed to both packages; float64 unless a test
says otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shared_cache  # noqa: F401  (one torch thread per test process)
from test_window_solver import BIAS_INFO, build_problem

from rivslam_tpu.backend import slam as ref_slam
from rivslam_tpu.core import config as ref_config
from rivslam_tpu.core import lie as ref_lie
from rivslam_tpu.factors import infomat as ref_infomat
from rivslam_tpu.factors import preintegration as ref_pre
from rivslam_tpu.factors import residuals as ref_res
from rivslam_tpu.factors import robust as ref_robust
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu.solver import window as ref_win
from rivslam_tpu_torch.backend import slam
from rivslam_tpu_torch.core import config, lie
from rivslam_tpu_torch.factors import infomat, preintegration, residuals, robust
from rivslam_tpu_torch.solver import window


def T(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def port(obj, cls):
    """A JAX dataclass of arrays as the port's dataclass of tensors."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kw[f.name] = port(v, preintegration.Preintegration) if dataclasses.is_dataclass(v) else T(v)
    return cls(**kw)


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---- Lie-group additions ----------------------------------------------------


@pytest.mark.parametrize(
    "name", ["so3_right_jacobian_inv", "so3_left_jacobian_inv", "se3_log",
             "normalize_rotation", "ypr_from_rot"],
)
def test_lie_additions_match_reference(name):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(64, 3)) * 1.2
    w[0], w[1] = 0.0, [1e-9, 0.0, 0.0]
    xi = rng.normal(size=(32, 6)) * 0.8
    arg = {
        "so3_right_jacobian_inv": w,
        "so3_left_jacobian_inv": w,
        "se3_log": np.asarray(ref_lie.se3_exp(jnp.asarray(xi))),
        "normalize_rotation": np.asarray(ref_lie.so3_exp(jnp.asarray(w))) + rng.normal(size=(64, 3, 3)) * 1e-3,
        "ypr_from_rot": np.asarray(ref_lie.so3_exp(jnp.asarray(w))),
    }[name]
    close(getattr(lie, name)(T(arg)), getattr(ref_lie, name)(jnp.asarray(arg)), 1e-9)


# ---- preintegration -----------------------------------------------------------


def _imu(seed, K=40, valid=None):
    rng = np.random.default_rng(seed)
    dts = rng.uniform(0.004, 0.006, K)
    acc = rng.normal(size=(K, 3)) * 0.3 + [0.0, 0.0, 9.8]
    gyr = rng.normal(size=(K, 3)) * 0.2
    mask = np.ones(K, bool) if valid is None else valid
    return dts, acc, gyr, mask


@pytest.mark.parametrize("kind,atol", [("f64", 1e-10), ("f32", 2e-4)])
def test_preintegrate_matches_reference(kind, atol):
    """Masked samples interleaved with valid ones, nonzero start biases."""
    jdt, tdt = (jnp.float64, torch.float64) if kind == "f64" else (jnp.float32, torch.float32)
    valid = np.ones(40, bool)
    valid[[0, 7, 8, 30]] = False
    valid[35:] = False
    dts, acc, gyr, mask = _imu(2, valid=valid)
    bg, ba = np.array([0.01, -0.02, 0.005]), np.array([0.1, 0.05, -0.08])
    args = (dts, acc, gyr, mask, bg, ba)
    want = ref_pre.preintegrate(*(jnp.asarray(a, jdt if a.dtype != bool else None) for a in args), 1e-3, 1e-2)
    got = preintegration.preintegrate(*(T(a, tdt if a.dtype != bool else None) for a in args), 1e-3, 1e-2)
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        close(getattr(got, f.name), w, atol * max(1.0, np.abs(w).max()))
    assert got.dR.dtype == tdt


@pytest.mark.parametrize("gaps", ["gaps", "empty", "tail-only"])
def test_fixed_capacity_preintegration_matches_reference(gaps):
    """The loop over the fixed capacity K: masked samples leave the state
    bitwise unchanged, so gaps anywhere, and an empty mask, give what the
    reference's masked lax.scan gives (float64)."""
    valid = np.ones(24, bool)
    if gaps == "gaps":
        valid[[1, 2, 9, 15, 16, 17, 23]] = False
    elif gaps == "empty":
        valid[:] = False
    else:
        valid[:20] = False
    dts, acc, gyr, mask = _imu(5, K=24, valid=valid)
    bg, ba = np.array([0.003, 0.01, -0.02]), np.array([-0.05, 0.02, 0.1])
    args = (dts, acc, gyr, mask, bg, ba)
    want = ref_pre.preintegrate(*(jnp.asarray(a, jnp.float64 if a.dtype != bool else None) for a in args),
                                1e-3, 1e-2)
    got = preintegration.preintegrate(*(T(a, torch.float64 if a.dtype != bool else None) for a in args),
                                      1e-3, 1e-2)
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        close(getattr(got, f.name), w, 1e-10 * max(1.0, np.abs(w).max()))
    if gaps == "empty":
        ident = preintegration.Preintegration.identity(torch.float64)
        for name in ("dt", "dR", "dv", "dp", "cov"):
            assert torch.equal(getattr(got, name), getattr(ident, name))
    # the valid samples alone, packed at the front, give the same state bitwise
    k = int(mask.sum())
    packed = [np.concatenate([a[mask], np.zeros((24 - k,) + a.shape[1:])]) for a in (dts, acc, gyr)]
    pmask = np.arange(24) < k
    got2 = preintegration.preintegrate(*(T(a, torch.float64) for a in packed), T(pmask),
                                       T(bg, torch.float64), T(ba, torch.float64), 1e-3, 1e-2)
    if k:
        # the midpoint partner of a sample after a gap is the last valid one
        # before it in both layouts, so the packed run is the same recurrence
        for a, b in zip(got.astuple(), got2.astuple()):
            assert torch.equal(a, b)


def test_predict_and_bias_corrected_deltas_match_reference():
    dts, acc, gyr, mask = _imu(3)
    z = np.zeros(3)
    want = ref_pre.preintegrate(*map(jnp.asarray, (dts, acc, gyr, mask, z, z)), 1e-3, 1e-2)
    got = preintegration.preintegrate(*map(T, (dts, acc, gyr, mask, z, z)), 1e-3, 1e-2)
    bg, ba = np.array([0.003, -0.001, 0.002]), np.array([0.02, 0.0, -0.03])
    close(preintegration.delta_rotation(got, T(bg)), ref_pre.delta_rotation(want, jnp.asarray(bg)), 1e-10)
    close(preintegration.delta_velocity(got, T(bg), T(ba)),
          ref_pre.delta_velocity(want, jnp.asarray(bg), jnp.asarray(ba)), 1e-10)
    close(preintegration.delta_position(got, T(bg), T(ba)),
          ref_pre.delta_position(want, jnp.asarray(bg), jnp.asarray(ba)), 1e-10)
    R = np.asarray(ref_lie.so3_exp(jnp.asarray([0.1, -0.2, 0.3])))
    state = dict(t=1.5, R=R, p=[1.0, 2.0, 3.0], v=[0.5, -0.1, 0.0], bg=bg, ba=ba)
    from rivslam_tpu.core.navstate import NavState as RefNav
    from rivslam_tpu_torch.core.navstate import NavState

    w = ref_pre.predict(RefNav(**{k: jnp.asarray(v) for k, v in state.items()}), want, 9.80511)
    g = preintegration.predict(NavState(**{k: T(v) for k, v in state.items()}), got, 9.80511)
    for f in ("t", "R", "p", "v", "bg", "ba"):
        close(getattr(g, f), getattr(w, f), 1e-10)


# ---- residuals and robust kernels -------------------------------------------


def test_residuals_match_reference_batched():
    """Each residual over a batch of 8 random states, against the reference
    vmapped; the port's functions batch over leading dims themselves."""
    rng = np.random.default_rng(4)
    B = 8
    R = [np.asarray(ref_lie.so3_exp(jnp.asarray(rng.normal(size=(B, 3))))) for _ in range(3)]
    p = [rng.normal(size=(B, 3)) * 3 for _ in range(3)]
    v = [rng.normal(size=(B, 3)) for _ in range(2)]
    bg, ba = rng.normal(size=(B, 3)) * 0.01, rng.normal(size=(B, 3)) * 0.1
    plane = np.concatenate([np.tile([0.05, -0.02, 1.0], (B, 1)), rng.normal(size=(B, 1))], 1)
    plane_m = plane + rng.normal(size=(B, 4)) * 0.01
    dts, acc, gyr, mask = _imu(5)
    z = np.zeros(3)
    pint = ref_pre.preintegrate(*map(jnp.asarray, (dts, acc, gyr, mask, z, z)), 1e-3, 1e-2)
    pint_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), pint)
    got_p = port(pint_b, preintegration.Preintegration)
    J = jnp.asarray
    cases = [
        ("bias_rw", (bg, ba)),
        ("relative_se3", (R[0], p[0], R[1], p[1], R[2], p[2])),
        ("pose_prior", (R[0], p[0], R[1], p[1])),
        ("velocity_prior", (v[0], v[1])),
        ("transform_plane", (R[0], p[0], plane)),
        ("se3_plane", (R[0], p[0], plane, plane_m)),
    ]
    for name, args in cases:
        want = jax.vmap(getattr(ref_res, name))(*map(J, args))
        close(getattr(residuals, name)(*map(T, args)), want, 1e-9)
    imu_args = (R[0], p[0], v[0], bg, ba, R[1], p[1], v[1])
    want = jax.vmap(ref_res.imu_preintegration)(*map(J, imu_args), pint_b)
    close(residuals.imu_preintegration(*map(T, imu_args), got_p), want, 1e-9)


@pytest.mark.parametrize(
    "name", ["NONE", "Huber", "Cauchy", "GemanMcClure", "Welsch", "Fair", "DCS",
             "Saturated", "Tukey", "PseudoHuber"],
)
def test_robust_kernel_weights_match_reference(name):
    chi2 = np.concatenate([[0.0, 0.5, 1.0, 1.5], np.logspace(-6, 4, 40)])
    close(robust.kernel_weight(name, 1.3, T(chi2)), ref_robust.kernel_weight(name, 1.3, jnp.asarray(chi2)), 1e-12)
    with pytest.raises(ValueError):
        robust.kernel_weight("NoSuchKernel", 1.0, T(chi2))


# ---- edge information (K3's caller) -------------------------------------------


def _cloud_pair(seed, n=300, m=280, cap=320):
    rng = np.random.default_rng(seed)
    xyz1 = np.zeros((cap, 3))
    xyz1[:n] = rng.normal(size=(n, 3)) * 8
    xyz2 = np.zeros((cap, 3))
    xyz2[:m] = xyz1[:m] + rng.normal(size=(m, 3)) * 0.05
    mask1, mask2 = np.arange(cap) < n, np.arange(cap) < m
    rel = np.asarray(ref_lie.se3_exp(jnp.asarray([0.01, -0.02, 0.03, 0.1, 0.0, -0.05])))
    return xyz1, mask1, xyz2, mask2, rel


@pytest.mark.parametrize("kind", ["f64", "f32"])
@pytest.mark.parametrize("max_range", [np.inf, 0.5])
def test_fitness_and_information_match_reference(kind, max_range):
    jdt, tdt = (jnp.float64, torch.float64) if kind == "f64" else (jnp.float32, torch.float32)
    xyz1, mask1, xyz2, mask2, rel = _cloud_pair(6)
    ja = (jnp.asarray(xyz1, jdt), jnp.asarray(mask1), jnp.asarray(xyz2, jdt), jnp.asarray(mask2), jnp.asarray(rel, jdt))
    ta = (T(xyz1, tdt), T(mask1), T(xyz2, tdt), T(mask2), T(rel, tdt))
    want = ref_infomat.fitness_score(*ja, max_range=max_range)
    got = infomat.fitness_score(*ta, max_range=max_range)
    assert got.dtype == tdt
    close(got, want, 0.0, rtol=1e-4 if kind == "f32" else 1e-9)
    for scaled in (True, False):
        cfg = dataclasses.replace(config.BackendConfig(), fitness_score_max_range=max_range)
        ref_cfg = dataclasses.replace(ref_config.BackendConfig(), fitness_score_max_range=max_range)
        close(infomat.calc_information_matrix(*ta, cfg, scaled=scaled),
              ref_infomat.calc_information_matrix(*ja, ref_cfg, scaled=scaled), 0.0,
              rtol=1e-4 if kind == "f32" else 1e-9)


def test_information_of_an_all_masked_previous_cloud():
    """The first frame's fitness runs against the window's empty slot: the
    reference sums +inf (score inf) and still returns a finite information;
    K3's 1e30 'no valid ref' must not leak into the score."""
    xyz1, _, xyz2, mask2, rel = _cloud_pair(7)
    mask1 = np.zeros(len(xyz1), bool)
    ja = (jnp.asarray(xyz1), jnp.asarray(mask1), jnp.asarray(xyz2), jnp.asarray(mask2), jnp.asarray(rel))
    ta = (T(xyz1), T(mask1), T(xyz2), T(mask2), T(rel))
    assert np.isinf(float(ref_infomat.fitness_score(*ja)))
    assert float(infomat.fitness_score(*ta)) == np.inf
    got = infomat.calc_information_matrix(*ta, config.BackendConfig())
    want = ref_infomat.calc_information_matrix(*ja, ref_config.BackendConfig())
    assert np.isfinite(got.numpy()).all()
    close(got, want, 0.0, rtol=1e-12)
    # no valid moved point at all: the reference's finfo.max
    ta0 = (T(xyz1), T(np.ones(len(xyz1), bool)), T(xyz2), T(np.zeros(len(xyz2), bool)), T(rel))
    assert float(infomat.fitness_score(*ta0)) == np.finfo(np.float64).max


def test_constant_information_matches_reference():
    ta = tuple(T(a) for a in _cloud_pair(8))
    cfg = dataclasses.replace(config.BackendConfig(), use_const_inf_matrix=True)
    ref_cfg = dataclasses.replace(ref_config.BackendConfig(), use_const_inf_matrix=True)
    want = ref_infomat.calc_information_matrix(*map(jnp.asarray, _cloud_pair(8)), ref_cfg)
    close(infomat.calc_information_matrix(*ta, cfg), want, 0.0, rtol=1e-12)


# ---- window solve ---------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    x0, f, truth = build_problem(noise_scale=1.0, init_perturb=0.05)
    return x0, f, port(x0, window.WindowState), port(f, window.WindowFactors)


def test_linearization_matches_reference(problem):
    x0, f, px0, pf = problem
    cfg, ref_cfg = config.BackendConfig(), ref_config.BackendConfig()
    r_w, kw_w = ref_win.residual_vector(x0, f, ref_cfg, BIAS_INFO)
    r, kw = window.residual_vector(px0, pf, cfg, BIAS_INFO)
    close(r, r_w, 1e-8, rtol=1e-9)
    H_w, g_w, y_w = ref_win.linearize_blocks(x0, f, ref_cfg, BIAS_INFO, kw_w)
    H, g, y = window.linearize_blocks(px0, pf, cfg, BIAS_INFO, kw)
    scale = np.abs(np.asarray(H_w)).max()
    close(H, H_w, 1e-9 * scale)
    close(g, g_w, 1e-9 * np.abs(np.asarray(g_w)).max())
    close(y, y_w, 0.0, rtol=1e-10)


@pytest.mark.parametrize("optimizer", ["LM", "GN"])
@pytest.mark.parametrize("use_schur", [False, True], ids=["dense", "schur"])
def test_solve_window_matches_reference(problem, optimizer, use_schur):
    x0, f, px0, pf = problem
    cfg = dataclasses.replace(config.BackendConfig(), optimizer=optimizer, max_solver_iterations=12)
    ref_cfg = dataclasses.replace(ref_config.BackendConfig(), optimizer=optimizer, max_solver_iterations=12)
    xw, chi2_w, it_w = ref_win.solve_window(x0, f, ref_cfg, BIAS_INFO, use_schur=use_schur)
    x, chi2, it = window.solve_window(px0, pf, cfg, BIAS_INFO, use_schur=use_schur)
    assert it == int(it_w)
    for name in ("R", "p", "v", "bg", "ba"):
        close(getattr(x, name), getattr(xw, name), 1e-8)
    close(chi2, chi2_w, 0.0, rtol=1e-7)


def test_solve_window_masked_frames(problem):
    """Leading empty slots (a window still filling up) are ignored alike."""
    x0, f, px0, pf = problem
    fm = np.array([False, False, True, True, True, True])
    f2 = dataclasses.replace(f, frame_mask=jnp.asarray(fm))
    pf2 = dataclasses.replace(pf, frame_mask=T(fm))
    cfg, ref_cfg = config.BackendConfig(), ref_config.BackendConfig()
    xw, chi2_w, it_w = ref_win.solve_window(x0, f2, ref_cfg, BIAS_INFO)
    x, chi2, it = window.solve_window(px0, pf2, cfg, BIAS_INFO)
    assert it == int(it_w)
    close(x.p, xw.p, 1e-8)
    close(chi2, chi2_w, 0.0, rtol=1e-7)


@pytest.mark.parametrize("optimizer", ["LM", "GN"])
def test_masked_iterations_past_convergence_change_nothing(problem, optimizer):
    """With a larger iteration cap, iterations after the solve converged
    (the carry's done flag set) leave the state, lambda and the flag
    bitwise unchanged; so do the inner tries after an accepted step, since
    the solve matches the reference's while_loop above."""
    _, _, px0, pf = problem
    cfg = dataclasses.replace(config.BackendConfig(), optimizer=optimizer, max_solver_iterations=40)
    cache = window.whiten_cache(pf, BIAS_INFO, px0.window, px0.p.dtype)
    x, chi2, it = window.solve_window(px0, pf, cfg, BIAS_INFO)
    assert it < cfg.max_solver_iterations
    carry = window.initial_carry(px0, cfg)
    for _ in range(it):
        carry = window.window_iteration(carry, pf, cfg, BIAS_INFO, cache)
    assert bool(carry[-1])
    for a, b in zip(carry[:5], x.astuple()):
        assert torch.equal(a, b)
    more = carry
    for _ in range(3):
        more = window.window_iteration(more, pf, cfg, BIAS_INFO, cache)
    for a, b in zip(more, carry):
        assert torch.equal(a, b)
    # the final chi2 is the one solve_window reports
    assert float(window.chi2_of(window.WindowState(*more[:5]), pf, cfg, BIAS_INFO, cache)) == float(chi2)


# ---- backend_step over a few frames ---------------------------------------------


def _backend_frames(n_frames=5, cap=192, imu_cap=48, fail_frame=None):
    """Frames along the simulator's circle: odometry poses with noise, a
    scan per frame, analytic IMU samples, ego velocity and the floor."""
    rng = np.random.default_rng(11)
    world = ref_syn.make_world(rng, n_points=4000)
    times, poses, vels = ref_syn.circular_trajectory(n_frames, dt=0.25, height=2.0)
    frames = []
    for i in range(n_frames):
        cl = ref_syn.observe(world, poses[i], rng, capacity=cap, noise=0.01, dtype=jnp.float64)
        rel = np.linalg.inv(poses[0]) @ poses[i]
        noise = np.asarray(ref_lie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.01)))
        odom = rel @ noise
        dts, acc, gyr, m = np.zeros(imu_cap), np.zeros((imu_cap, 3)), np.zeros((imu_cap, 3)), np.zeros(imu_cap, bool)
        if i > 0:
            d, a, g = ref_syn.circular_imu_samples(times[i - 1], times[i], rate=100.0)
            k = len(d)
            dts[:k], acc[:k], gyr[:k], m[:k] = d, a, g, True
        ego = poses[i][:3, :3].T @ vels[i]
        if i == fail_frame:
            ego = ego * 0 + 500.0  # absurd ego velocity: forces the failure path
        frames.append(dict(
            stamp=np.asarray(times[i]), odom_R=odom[:3, :3], odom_p=odom[:3, 3],
            xyz=np.asarray(cl.xyz), mask=np.asarray(cl.mask), ego_vel=ego,
            ego_vel_cov=np.full(3, 1e-3), imu_dts=dts, imu_acc=acc, imu_gyr=gyr, imu_mask=m,
            floor=np.array([0.0, 0.0, 1.0, 2.0]) + rng.normal(size=4) * 1e-3,
            floor_valid=np.asarray(i % 3 != 1),
        ))
    return frames


@pytest.mark.parametrize("fail_frame", [None, 3], ids=["nominal", "failure-reset"])
def test_backend_step_matches_reference(fail_frame):
    bk, imu = config.BackendConfig(), config.ImuConfig()
    ref_bk, ref_imu = ref_config.BackendConfig(), ref_config.ImuConfig()
    st = slam.init_state(bk, imu, 192, torch.float64)
    ref_st = ref_slam.init_state(ref_bk, ref_imu, 192, jnp.float64)
    step = jax.jit(lambda s, f: ref_slam.backend_step(s, f, ref_bk, ref_imu))
    failures = []
    for fr in _backend_frames(fail_frame=fail_frame):
        ref_st, want = step(ref_st, ref_slam.BackendFrame(**{k: jnp.asarray(v) for k, v in fr.items()}))
        st, got = slam.backend_step(st, slam.BackendFrame(**{k: T(v) for k, v in fr.items()}), bk, imu)
        assert got.iterations == int(want.iterations)
        assert bool(got.failure) == bool(want.failure)
        close(got.pose, want.pose, 1e-7)
        close(got.trans_odom2map, want.trans_odom2map, 1e-7)
        close(got.chi2, want.chi2, 0.0, rtol=1e-6)
        close(st.nav.v, ref_st.nav.v, 1e-6)
        close(st.rel_info, ref_st.rel_info, 0.0, rtol=1e-9)
        failures.append(bool(got.failure))
    if fail_frame is not None:
        assert failures[fail_frame]
