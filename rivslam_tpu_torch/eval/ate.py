"""Trajectory evaluation: ATE / RE in the rpg_trajectory_evaluation style
(the port's copy of ``rivslam_tpu/eval/ate.py``, held equal to it by the tests).

The reference defers accuracy numbers to rpg_trajectory_evaluation on the
exported TUM file (README.md:62-63). We reimplement the core protocol:
SE(3) (or Sim(3)) Umeyama alignment of estimate to ground truth, absolute
trajectory error stats, and relative error over distance-binned sub-paths.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment est -> gt.

    est, gt: [F, 3] positions. Returns (s, R, t) with gt ~ s R est + t.
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec**2).sum() / len(est)
        s = np.trace(np.diag(D) @ S) / var_e
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate(est_pos: np.ndarray, gt_pos: np.ndarray, align: bool = True) -> dict:
    """Absolute trajectory error after SE(3) alignment. Returns stats dict."""
    if align:
        s, R, t = umeyama_alignment(est_pos, gt_pos)
        est_aligned = (s * (R @ est_pos.T)).T + t
    else:
        est_aligned = est_pos
    err = np.linalg.norm(est_aligned - gt_pos, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "std": float(err.std()),
    }


def relative_error(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 10
) -> dict:
    """Relative pose error over fixed frame-delta sub-paths.

    est_poses, gt_poses: [F, 4, 4].
    """
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        dd = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(dd[:3, 3]))
        cos = np.clip((np.trace(dd[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.degrees(np.arccos(cos)))
    t_errs = np.asarray(t_errs)
    r_errs = np.asarray(r_errs)
    return {
        "trans_rmse": float(np.sqrt((t_errs**2).mean())),
        "trans_mean": float(t_errs.mean()),
        "rot_rmse_deg": float(np.sqrt((r_errs**2).mean())),
        "rot_mean_deg": float(r_errs.mean()),
    }
