"""A second witness for the frozen reference's ego velocity and window
backend: the same methods written again in NumPy float64 from their
equations, sharing no code with the port or its frozen copy, for
``test_bench_witness.py`` to hold the frozen copy against at a cell's
shapes.

- ``ego_velocity``: REVE (Doer and Trommer): Doppler d_i = u_i . v over the
  valid targets, RANSAC hypotheses of the ``n_ransac_points`` best-scored
  targets, the hypothesis with most inliers, and a least-squares fit with
  its covariance; with the estimator's zero-velocity gate and its rule that
  an outlier share over 5% takes every valid target as an inlier.
- ``preintegrate``: Forster's on-manifold IMU preintegration, midpoint
  samples, with its 9x9 covariance and bias Jacobians.
- ``Window``: the sliding window's objective (bias random walks, relative
  odometry, odometry prior, IMU, velocity, floor plane, each whitened by
  its information, Huber where the configuration asks), g2o's
  Levenberg-Marquardt on it as the backend configures it (``solve``: the
  kernels reweighted at each linearization, at most
  ``max_solver_iterations`` outer iterations of at most 8 damping tries),
  and the objective's minimum (``minimize``), both on numerical Jacobians.
"""

from __future__ import annotations

import math

import numpy as np

def hat(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def exp(w):
    th = np.linalg.norm(w)
    K = hat(w)
    if th < 1e-8:
        return np.eye(3) + K + 0.5 * K @ K
    return np.eye(3) + math.sin(th) / th * K + (1.0 - math.cos(th)) / th**2 * K @ K


def log(R):
    v = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.linalg.norm(v)
    th = math.atan2(s, 0.5 * (np.trace(R) - 1.0))
    return v * (th / s if s > 1e-12 else 1.0 + s * s / 6.0)


def right_jacobian(w):
    th = np.linalg.norm(w)
    K = hat(w)
    if th < 1e-8:
        return np.eye(3) - 0.5 * K + K @ K / 6.0
    return np.eye(3) - (1.0 - math.cos(th)) / th**2 * K + (th - math.sin(th)) / th**3 * K @ K


# ---- REVE ---------------------------------------------------------------------


def ego_velocity(xyz, doppler, intensity, mask, cfg, uniforms):
    """(v, sigma, success, inliers) of one scan; ``uniforms`` [iters, N]
    score the targets for each hypothesis (higher first, ties by index)."""
    xyz, dop = np.asarray(xyz, np.float64), np.asarray(doppler, np.float64) * cfg.doppler_velocity_correction_factor
    r = np.linalg.norm(xyz, axis=1)
    az = np.arctan2(xyz[:, 1], xyz[:, 0])
    el = np.arctan2(np.hypot(xyz[:, 0], xyz[:, 1]), xyz[:, 2]) - math.pi / 2
    valid = (np.asarray(mask) & (r > cfg.min_dist) & (r < cfg.max_dist) & (np.asarray(intensity) > cfg.min_db)
             & (np.abs(az) < math.radians(cfg.azimuth_thresh_deg))
             & (np.abs(el) < math.radians(cfg.elevation_thresh_deg)))
    u = xyz / np.maximum(r, 1e-9)[:, None]
    n_valid = int(valid.sum())
    absd = np.sort(np.abs(dop[valid]))
    q = int(math.floor(n_valid * (1.0 - cfg.allowed_outlier_percentage)))
    gate = absd[q] if q < n_valid else math.inf
    if gate < cfg.thresh_zero_velocity:
        sig = np.array([cfg.sigma_zero_velocity_x, cfg.sigma_zero_velocity_y, cfg.sigma_zero_velocity_z])
        return np.zeros(3), sig, n_valid > 2, valid & (np.abs(dop) < cfg.thresh_zero_velocity)

    def fit(sel):
        A = u[sel].T @ u[sel] + 1e-9 * np.eye(3)
        return np.linalg.solve(A, u[sel].T @ dop[sel])

    idx = np.flatnonzero(valid)
    best, best_n = None, -1
    for row in np.asarray(uniforms, np.float64):
        pick = idx[np.argsort(-row[idx], kind="stable")[:cfg.n_ransac_points]]
        inl = valid & (np.abs(dop - u @ fit(pick)) < cfg.inlier_thresh)
        if (n_valid - inl.sum()) / max(n_valid, 1) > 0.05:
            inl = valid.copy()
        if inl.sum() > best_n:
            best, best_n = inl, int(inl.sum())
    v = fit(best)
    e = (u @ v - dop)[best]
    A = u[best].T @ u[best]
    var = np.diag(e @ e * np.linalg.inv(A + 1e-9 * np.eye(3)) / max(best.sum() - 3.0, 1.0))
    sigma = np.sqrt(np.maximum(var, 0.0)) + np.array([cfg.sigma_offset_radar_x, cfg.sigma_offset_radar_y,
                                                       cfg.sigma_offset_radar_z])
    ok = (bool(np.all(var >= 0)) and sigma[0] < cfg.max_sigma_x and sigma[1] < cfg.max_sigma_y
          and sigma[2] < cfg.max_sigma_z and n_valid > 2 and best_n > 0)
    return v, sigma, ok, best


# ---- IMU preintegration -----------------------------------------------------------


def preintegrate(dts, acc, gyr, mask, bg, ba, noise_gyro, noise_acc) -> dict:
    """The deltas (dt, dR, dv, dp), their bias Jacobians and the 9x9
    covariance in (rotation, velocity, position) order. A sample's
    midpoint partner is the last valid sample before it (itself for the
    first)."""
    d = dict(dt=0.0, dR=np.eye(3), dv=np.zeros(3), dp=np.zeros(3), dR_dbg=np.zeros((3, 3)),
             dV_dbg=np.zeros((3, 3)), dV_dba=np.zeros((3, 3)), dP_dbg=np.zeros((3, 3)),
             dP_dba=np.zeros((3, 3)), cov=np.zeros((9, 9)), bg=np.asarray(bg, np.float64),
             ba=np.asarray(ba, np.float64))
    last = None
    for k in range(len(dts)):
        if not mask[k]:
            continue
        j = k if last is None else last
        last = k
        dt = float(dts[k])
        w = 0.5 * (gyr[j] + gyr[k]) - d["bg"]
        a = 0.5 * (acc[j] + acc[k]) - d["ba"]
        dRk, Jr = exp(w * dt), right_jacobian(w * dt)
        dR, ah = d["dR"], hat(a)
        A = np.eye(9)
        A[0:3, 0:3] = dRk.T
        A[3:6, 0:3] = -dR @ ah * dt
        A[6:9, 0:3] = -0.5 * dR @ ah * dt * dt
        A[6:9, 3:6] = dt * np.eye(3)
        Bg = np.vstack([Jr * dt, np.zeros((6, 3))])
        Ba = np.vstack([np.zeros((3, 3)), dR * dt, 0.5 * dR * dt * dt])
        cov = A @ d["cov"] @ A.T + noise_gyro**2 * Bg @ Bg.T + noise_acc**2 * Ba @ Ba.T
        d.update(
            dp=d["dp"] + d["dv"] * dt + 0.5 * dR @ a * dt * dt,
            dv=d["dv"] + dR @ a * dt,
            dR_dbg=dRk.T @ d["dR_dbg"] - Jr * dt,
            dV_dbg=d["dV_dbg"] - dR @ ah @ d["dR_dbg"] * dt,
            dV_dba=d["dV_dba"] - dR * dt,
            dP_dbg=d["dP_dbg"] + d["dV_dbg"] * dt - 0.5 * dR @ ah @ d["dR_dbg"] * dt * dt,
            dP_dba=d["dP_dba"] + d["dV_dba"] * dt - 0.5 * dR * dt * dt,
            dR=dR @ dRk, dt=d["dt"] + dt, cov=cov,
        )
    return d


# ---- the window ---------------------------------------------------------------------


def _huber(s, delta):
    return s if s <= delta * delta else 2.0 * delta * math.sqrt(s) - delta * delta


def _huber_weight(s, delta):
    return 1.0 if s <= delta * delta else delta / math.sqrt(s)


def _plane_basis(n):
    a = -1.0 / (1.0 + max(n[2], -1.0 + 1e-6))
    b = n[0] * n[1] * a
    return np.array([1.0 + n[0] ** 2 * a, b, -n[0]]), np.array([b, 1.0 + n[1] ** 2 * a, -n[1]])


class Window:
    """One backend step: the window after the new frame is pushed, its
    factors, and the objective over the states (R, p, v, bg, ba) of its W
    slots. ``state`` holds the window before the frame (numpy arrays under
    the backend state's field names), ``frame`` the frame's inputs."""

    def __init__(self, state: dict, frame: dict, cfg, imu_cfg):
        W = cfg.window_size
        g = np.array([0.0, 0.0, imu_cfg.gravity])
        R, p, v, bg, ba = (np.array(state[k], np.float64) for k in ("R", "p", "v", "bg", "ba"))
        pre = preintegrate(frame["imu_dts"], frame["imu_acc"], frame["imu_gyr"], frame["imu_mask"], bg[-1], ba[-1],
                           imu_cfg.gyr_noise, imu_cfg.acc_noise)
        first = not np.any(state["frame_mask"])
        oR, op = np.array(frame["odom_R"], np.float64), np.array(frame["odom_p"], np.float64)
        if first:
            new = (oR, op, np.zeros(3), np.full(3, imu_cfg.gyr_bias_noise), np.full(3, imu_cfg.acc_bias_noise))
        else:
            new = (R[-1] @ pre["dR"], R[-1] @ pre["dp"] + p[-1] + v[-1] * pre["dt"] - 0.5 * g * pre["dt"] ** 2,
                   R[-1] @ pre["dv"] + v[-1] - g * pre["dt"], bg[-1], ba[-1])
        rel_R = oR.T @ state["odom_R"][-1]
        rel_p = oR.T @ (state["odom_p"][-1] - op)
        rel_info = self._information(frame["xyz"], frame["mask"], state["xyz"][-1], state["cloud_mask"][-1],
                                     rel_R, rel_p, cfg)
        cov = np.asarray(frame["ego_vel_cov"], np.float64)
        vel_info = 0.01 / np.maximum(cov, 1e-12) if np.all(cov > 0) else np.full(3, 10.0)
        floor = np.asarray(frame["floor"], np.float64) if frame["floor_valid"] else np.array([0.0, 0.0, 1.0, 0.5])

        def push(a, x):
            return np.concatenate([np.asarray(a, np.float64)[1:], np.asarray(x, np.float64)[None]])

        self.x0 = [push(a, x) for a, x in zip((R, p, v, bg, ba), new)]
        self.frame_mask = np.concatenate([np.asarray(state["frame_mask"])[1:], [True]])
        self.odom_R, self.odom_p = push(state["odom_R"], oR), push(state["odom_p"], op)
        self.rel_R, self.rel_p = push(state["rel_R"], rel_R), push(state["rel_p"], rel_p)
        self.rel_info = push(state["rel_info"], rel_info)
        self.preint = [dict((k, np.asarray(v_[i], np.float64)) for k, v_ in state["preint"].items())
                       for i in range(1, W)] + [pre]
        self.preint_info = push(state["preint_info"],
                                np.linalg.inv(pre["cov"] + 1e-10 * np.eye(9)) * cfg.inertial_weight)
        ego = push(state["ego_vel"], frame["ego_vel"])
        self.vel_meas = np.einsum("wij,wj->wi", self.x0[0], ego)  # rotated by the window before its solve
        self.vel_info = push(state["vel_info"], vel_info)
        self.floor = push(state["floor"], floor)
        self.floor_valid = np.concatenate([np.asarray(state["floor_valid"])[1:], [True]])
        self.bias_info = (1.0 / imu_cfg.gyr_noise**2, 1.0 / imu_cfg.acc_noise**2)
        self.g, self.cfg, self.W = g, cfg, W

    @staticmethod
    def _information(xyz1, mask1, xyz2, mask2, R, p, cfg):
        """diag(1/var_q x3, 1/var_x x3) from the mean squared nearest-
        neighbour distance of cloud 2, moved by (R, p), against cloud 1,
        mapped by the exponential gain to [min, max] variances and scaled by
        1e-8, as the backend does."""
        a, b = np.asarray(xyz1, np.float64)[np.asarray(mask1)], np.asarray(xyz2, np.float64)[np.asarray(mask2)]
        if len(a) == 0:
            f = math.inf
        elif len(b) == 0:
            f = np.finfo(np.float64).max
        else:
            moved = b @ R.T + p
            d2 = ((moved[:, None, :] - a[None, :, :]) ** 2).sum(-1).min(1)
            f = float(d2.mean())

        def var(lo, hi):
            y = (1.0 - math.exp(-cfg.var_gain_a * f)) / (1.0 - math.exp(-cfg.var_gain_a * 0.5))
            return 1e-8 * (lo + (hi - lo) * y)

        vq, vx = var(cfg.min_stddev_q**2, cfg.max_stddev_q**2), var(cfg.min_stddev_x**2, cfg.max_stddev_x**2)
        return np.diag([1.0 / vq] * 3 + [1.0 / vx] * 3)

    def blocks(self, x):
        """[(whitened residual, kernel width or None)] of every live factor."""
        R, p, v, bg, ba = x
        cfg, out = self.cfg, []
        for i in range(1, self.W):
            if not (self.frame_mask[i] and self.frame_mask[i - 1]):
                continue
            Rp, pp, vp, bgp, bap, Rc, pc, vc, bgc, bac = R[i - 1], p[i - 1], v[i - 1], bg[i - 1], ba[i - 1], \
                R[i], p[i], v[i], bg[i], ba[i]
            out.append((math.sqrt(self.bias_info[0]) * (bgc - bgp), None))
            out.append((math.sqrt(self.bias_info[1]) * (bac - bap), None))
            L = np.linalg.cholesky(self.rel_info[i] + 1e-12 * np.eye(6))
            rel = np.concatenate([log(self.rel_R[i].T @ Rc.T @ Rp), Rc.T @ (pp - pc) - self.rel_p[i]])
            out.append((L.T @ rel, None if cfg.odometry_edge_robust_kernel == "NONE"
                        else cfg.odometry_edge_robust_kernel_size))
            prior = np.concatenate([log(self.odom_R[i].T @ Rc), pc - self.odom_p[i]])
            out.append((L.T @ prior, cfg.scan_match_prior_robust_kernel_size))
            q = self.preint[i]
            dR = q["dR"] @ exp(q["dR_dbg"] @ (bgp - q["bg"]))
            dv = q["dv"] + q["dV_dbg"] @ (bgp - q["bg"]) + q["dV_dba"] @ (bap - q["ba"])
            dp = q["dp"] + q["dP_dbg"] @ (bgp - q["bg"]) + q["dP_dba"] @ (bap - q["ba"])
            dt = float(q["dt"])
            imu = np.concatenate([log(dR.T @ Rp.T @ Rc), Rp.T @ (vc - vp + self.g * dt) - dv,
                                  Rp.T @ (pc - pp - vp * dt + 0.5 * self.g * dt * dt) - dp])
            Li = np.linalg.cholesky(self.preint_info[i] + 1e-12 * np.eye(9))
            out.append((Li.T @ imu, cfg.integ_edge_robust_kernel_size))
            out.append((np.sqrt(self.vel_info[i]) * (vc - self.vel_meas[i]), None))
            if self.floor_valid[i]:
                node = self.floor[i - 1]
                n_est = Rc.T @ node[:3]
                n_est = n_est / np.linalg.norm(n_est)
                n_meas = self.floor[i, :3] / np.linalg.norm(self.floor[i, :3])
                t1, t2 = _plane_basis(n_meas)
                plane = np.array([t1 @ n_est, t2 @ n_est, node[3] + node[:3] @ pc - self.floor[i, 3]])
                out.append((1e3 * plane, cfg.floor_edge_robust_kernel_size))
        return out

    def chi2(self, x) -> float:
        """The squares of the whitened residuals, each weighted by its
        kernel's weight at it: what the backend reports as the window's
        chi2."""
        return sum(_huber_weight(r @ r, k) * (r @ r) if k else r @ r for r, k in self.blocks(x))

    def objective(self, x) -> float:
        """The robust objective the kernels' reweighted normal equations
        minimize: Huber of each square where a kernel is set."""
        return sum(_huber(r @ r, k) if k else r @ r for r, k in self.blocks(x))

    def retract(self, x, d):
        d = d.reshape(self.W, 15)
        return [np.stack([x[0][i] @ exp(d[i, :3]) for i in range(self.W)]), x[1] + d[:, 3:6], x[2] + d[:, 6:9],
                x[3] + d[:, 9:12], x[4] + d[:, 12:15]]

    def _weights(self, x) -> np.ndarray:
        """Each residual row's square-root kernel weight at x."""
        return np.concatenate([np.full(len(r), math.sqrt(_huber_weight(r @ r, k)) if k else 1.0)
                               for r, k in self.blocks(x)])

    def _weighted_chi2(self, x, w) -> float:
        r = np.concatenate([r for r, _ in self.blocks(x)]) * w
        return float(r @ r)

    def solve(self):
        """(x, chi2) of g2o's Levenberg-Marquardt from the pushed window:
        lambda starts at 1e-5 of H's largest diagonal entry; a try solves
        (H + lambda I) d = -g and is taken where it lowers the chi2 under
        the linearization's kernel weights, lambda then scaled by
        max(1/3, 1 - (2 rho - 1)^3), else by nu, which doubles; an outer
        iteration ends at a taken try, after 8 tries, or at a step under
        1e-8, and the solve when a taken step's chi2 gain is under 1e-9 of
        it (or the step under 1e-6), when no try is taken, or after
        ``max_solver_iterations``."""
        x, lam = self.x0, None
        for _ in range(self.cfg.max_solver_iterations):
            w = self._weights(x)
            H, g = self._system(x, w)
            y0 = self._weighted_chi2(x, w)
            if lam is None:
                lam = 1e-5 * np.max(np.abs(np.diag(H)))
            nu, x_new_best, success, y_best, dmax = 2.0, x, False, y0, math.inf
            for _ in range(8):
                d = np.linalg.solve(H + lam * np.eye(len(g)), -g)
                x_new = self.retract(x, d)
                y1 = self._weighted_chi2(x_new, w)
                denom = d @ (lam * d - g)
                rho = (y0 - y1) / (denom if abs(denom) >= 1e-30 else 1e-30)
                if rho > 0 and y1 < y0:
                    lam *= max(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
                    x_new_best, success, y_best, dmax = x_new, True, y1, np.max(np.abs(d))
                    break
                lam *= nu
                nu *= 2.0
                if np.linalg.norm(d) < 1e-8:
                    break
            x = x_new_best
            if not success or abs(y0 - y_best) < 1e-9 * max(y0, 1.0) or dmax < 1e-6:
                break
        return x, self.chi2(x)

    def _system(self, x, w=None):
        """Gauss-Newton's H and gradient of the residuals, each row
        weighted by its kernel's square-root weight at x (or by ``w``), the
        Jacobian by central differences."""
        bl = self.blocks(x)
        w = self._weights(x) if w is None else w
        r0 = np.concatenate([r for r, _ in bl]) * w
        n, h = 15 * self.W, 1e-7
        J = np.zeros((len(r0), n))
        for j in range(n):
            e = np.zeros(n)
            e[j] = h
            plus = np.concatenate([r for r, _ in self.blocks(self.retract(x, e))])
            minus = np.concatenate([r for r, _ in self.blocks(self.retract(x, -e))])
            J[:, j] = (plus - minus) * w / (2 * h)
        return J.T @ J, J.T @ r0

    def minimize(self, x=None, iterations: int = 60):
        """(x, objective) at the minimum Levenberg-Marquardt reaches from
        ``x`` (the pushed window by default)."""
        x = self.x0 if x is None else x
        f, lam = self.objective(x), 1e-6
        for _ in range(iterations):
            H, grad = self._system(x)
            D = np.diag(np.maximum(np.diag(H), 1e-12))
            moved = False
            for _ in range(12):
                try:
                    d = -np.linalg.solve(H + lam * D, grad)
                except np.linalg.LinAlgError:
                    lam *= 10.0
                    continue
                x_new = self.retract(x, d)
                f_new = self.objective(x_new)
                if f_new < f:
                    x, f, moved = x_new, f_new, True
                    lam = max(lam / 10.0, 1e-12)
                    break
                lam *= 10.0
            if not moved or np.max(np.abs(d)) < 1e-12:
                break
        return x, f
