"""Seeded, well-posed sliding windows for the window solve's tests, built
with the port alone (no JAX, so the card's tests can use them too): the
construction of tests/test_window_solver.build_problem, a smooth
accelerating and yawing trajectory of W frames, its IMU preintegrated,
noisy odometry and velocity, a floor plane, and a perturbed start."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.navstate import GRAVITY
from rivslam_tpu_torch.factors import preintegration as pre
from rivslam_tpu_torch.factors import residuals
from rivslam_tpu_torch.solver import window

W = 6
FRAME_DT = 0.1
IMU_DT = 0.005
NOISE_GYRO = 1e-3
NOISE_ACC = 1e-2
INERTIAL_WEIGHT = 0.001
BIAS_INFO = (1.0 / NOISE_GYRO**2, 1.0 / NOISE_ACC**2)

# the window kernel against its twin (float32, the twin on the CPU), by the
# windows' robust kernels: state (m, rad, m/s) and relative chi2 within about
# ten times the twin's own spread over one-ulp nudges of every input (seeds 2
# and 5, dense and Schur: NONE 9.2e-6 and 4.9e-7, the shipped kernels 1.1e-6
# and 4.3e-7, Cauchy 1.0e-4 and 2.3e-5), iterations and tries equal, as the
# nudges leave them. GN with Cauchy everywhere is left out: its near-undamped
# f32 step is so ill-conditioned that the twin's dense and Schur solves part by
# 0.11 after one iteration (they agree to 1e-11 in float64)
WINDOW_TOL = {"NONE": (1e-4, 5e-6), "shipped": (2e-5, 5e-6), "Cauchy": (1e-3, 3e-4)}


def _exp(w) -> np.ndarray:
    return lie.so3_exp(torch.as_tensor(np.asarray(w, np.float64))).numpy()


def _truth(windows: int):
    g = np.array([0.0, 0.0, GRAVITY])
    omega = np.array([0.0, 0.0, 0.25])
    R, p, v = np.eye(3), np.zeros(3), np.array([1.5, 0.0, 0.0])
    Rs, ps, vs, imu = [R], [p], [v], []
    n_sub, t = int(FRAME_DT / IMU_DT), 0.0
    step = _exp(omega * IMU_DT / 5)
    for _ in range(windows - 1):
        accs, gyrs = [], []
        for _ in range(n_sub):
            a_w = np.array([0.2 * np.sin(t), 0.3 * np.cos(t), 0.05 * np.sin(2 * t)])
            accs.append(R.T @ (a_w + g))
            gyrs.append(omega.copy())
            for _ in range(5):
                h = IMU_DT / 5
                p = p + v * h + 0.5 * a_w * h * h
                v = v + a_w * h
                R = R @ step
            t += IMU_DT
        imu.append((np.full(n_sub, IMU_DT), np.array(accs), np.array(gyrs)))
        Rs.append(R)
        ps.append(p)
        vs.append(v)
    return np.array(Rs), np.array(ps), np.array(vs), imu


def make_window(seed: int = 1, noise_scale: float = 1.0, init_perturb: float = 0.05,
                windows: int = W, dtype=torch.float64, device="cpu"):
    """(x0, factors) of a window of ``windows`` slots, float64 numbers cast
    to ``dtype`` on ``device``."""
    rng = np.random.default_rng(seed)
    Rs, ps, vs, imu = _truth(windows)
    f64 = torch.float64
    preints = [pre.Preintegration.identity(f64)]
    for dts, accs, gyrs in imu:
        preints.append(pre.preintegrate(
            torch.as_tensor(dts), torch.as_tensor(accs), torch.as_tensor(gyrs),
            torch.ones(len(dts), dtype=torch.bool), torch.zeros(3, dtype=f64), torch.zeros(3, dtype=f64),
            NOISE_GYRO, NOISE_ACC))
    preint = pre.Preintegration(*(torch.stack(ts) for ts in zip(*(q.astuple() for q in preints))))
    cov = preint.cov.numpy().copy()
    cov[0] = np.eye(9)  # the unused slot
    preint_info = np.linalg.inv(cov + 1e-14 * np.eye(9)) * INERTIAL_WEIGHT

    noise = rng.normal(size=(windows, 6)) * 0.01 * noise_scale
    odom_R = np.stack([Rs[i] @ _exp(noise[i, :3]) for i in range(windows)])
    odom_p = ps + noise[:, 3:]
    rel_R = np.stack([np.eye(3)] + [odom_R[i].T @ odom_R[i - 1] for i in range(1, windows)])
    rel_p = np.stack([np.zeros(3)] + [odom_R[i].T @ (odom_p[i - 1] - odom_p[i]) for i in range(1, windows)])
    info6 = np.tile(np.eye(6) * 1e4, (windows, 1, 1))
    vel_meas = vs + rng.normal(size=(windows, 3)) * 0.02 * noise_scale
    plane = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=f64)
    plane_meas = torch.stack([residuals.transform_plane(torch.as_tensor(Rs[i]), torch.as_tensor(ps[i]), plane)
                              for i in range(windows)])
    perturb = rng.normal(size=(windows, 15)) * init_perturb

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    f = window.WindowFactors(
        frame_mask=torch.ones(windows, dtype=torch.bool, device=device),
        rel_R=t(rel_R), rel_p=t(rel_p), rel_info=t(info6), prior_R=t(odom_R), prior_p=t(odom_p),
        prior_info=t(info6), preint=pre.Preintegration(*(t(a) for a in preint.astuple())),
        preint_info=t(preint_info), vel_meas=t(vel_meas), vel_info=t(np.full((windows, 3), 10.0)),
        plane_node=t(plane.expand(windows, 4)), plane_meas=t(plane_meas),
        plane_info=t(np.full(windows, 10.0)), plane_valid=torch.ones(windows, dtype=torch.bool, device=device),
    )
    x0 = window.WindowState(
        R=t(np.stack([Rs[i] @ _exp(perturb[i, :3]) for i in range(windows)])),
        p=t(ps + perturb[:, 3:6]), v=t(vs + perturb[:, 6:9]),
        bg=t(perturb[:, 9:12] * 0.01), ba=t(perturb[:, 12:15] * 0.01),
    )
    return x0, f


def nudged(obj, toward: float):
    """A state or factors with every float tensor one ulp toward ``toward``
    (+inf or -inf)."""
    def one(v):
        if dataclasses.is_dataclass(v):
            return nudged(v, toward)
        return torch.nextafter(v, torch.full_like(v, toward)) if v.is_floating_point() else v

    return type(obj)(**{fl.name: one(getattr(obj, fl.name)) for fl in dataclasses.fields(obj)})


def twin_limits(x0, f, cfg, bias_info, use_schur: bool = False, kernels: str = "shipped"):
    """The window kernel's limits against its twin on this window (state in
    m, rad, m/s; relative chi2): three times the twin's own spread here, its
    runs on one-ulp nudges of every input and with the other factorization
    (dense or Schur) against its run, or ``WINDOW_TOL``, whichever is
    larger. A window the Engine rolls early in a run constrains its biases
    weakly, and there the spread is far above the synthetic windows'."""
    xt, chi2_t, _, _ = window.solve_window(x0, f, cfg, bias_info, use_schur)
    runs = [window.solve_window(nudged(x0, t), nudged(f, t), cfg, bias_info, use_schur) for t in (np.inf, -np.inf)]
    runs.append(window.solve_window(x0, f, cfg, bias_info, not use_schur))
    state = max(float((a - b).abs().max()) for r in runs for a, b in zip(r[0].astuple(), xt.astuple()))
    chi2 = max(abs(float(r[1]) - float(chi2_t)) / max(abs(float(chi2_t)), 1e-30) for r in runs)
    tol_state, tol_chi2 = WINDOW_TOL[kernels]
    return max(tol_state, 3 * state), max(tol_chi2, 3 * chi2)
