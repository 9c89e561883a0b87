"""Loop detection (port of ``rivslam_tpu/loop/detector.py``): the candidate
prefilter, registration verification, and the odometry and pairwise
consistency checks (loop_detector.cpp:100-332).

The per-keyframe gates (accum distance, yaw difference, drift-scaled
ellipses, loop interval, barometer) are one masked pass over all keyframes.
Verification registers with the engine's own ``RegistrationConfig`` through
``frontend/apdgicp.prepare_and_register``: K1 runs there under the fast
configurations, K2 under the exact ones. ``verify_loops_batch`` registers
its B candidates as one batch of B problems.
"""

from __future__ import annotations

import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import LoopConfig, RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp


def prefilter_candidates(
    accum_dist: torch.Tensor,  # [K] accumulated travel distance per keyframe
    est_R: torch.Tensor,  # [K,3,3] current pose estimates
    est_p: torch.Tensor,  # [K,3]
    node_mask: torch.Tensor,  # [K]
    new_idx: int,  # index of the query keyframe
    last_loop_accum: float,  # accum distance at the last loop edge
    cfg: LoopConfig,
    altitude: torch.Tensor | None = None,  # [K] barometer altitude per keyframe
    altitude_valid: torch.Tensor | None = None,  # [K]
) -> torch.Tensor:
    """find_candidates (loop_detector.cpp:139-189) as one masked pass,
    including the optional barometer altitude gate (:157-161)."""
    new_accum = accum_dist[new_idx]
    dist_btn_last = new_accum - last_loop_accum
    interval_ok = dist_btn_last >= cfg.min_loop_interval_dist
    accum_ok = (new_accum - accum_dist) >= cfg.accum_distance_thresh

    Rn, pn = est_R[new_idx], est_p[new_idx]
    rel_R = torch.einsum("kji,jl->kil", est_R, Rn)  # R_k^T R_new
    rel_p = torch.einsum("kji,kj->ki", est_R, pn - est_p)
    yaw = torch.atan2(rel_R[:, 1, 0], rel_R[:, 0, 0])
    yaw_ok = torch.abs(torch.rad2deg(yaw)) <= cfg.max_yaw_difference_deg

    x, y = rel_p[:, 0], rel_p[:, 1]
    drift = cfg.odom_drift_xy * cfg.drift_scale_xy
    rad_lle = 3.0 + dist_btn_last * drift
    aa_lle = (x / rad_lle) ** 2 + (y / rad_lle) ** 2
    rad_xy = 10.0 + drift * (new_accum - accum_dist)
    aa = (x / rad_xy) ** 2 + (y / rad_xy) ** 2
    ellipse_ok = (aa_lle <= 1.0) & (aa <= 1.0)

    ok = node_mask & interval_ok & accum_ok & yaw_ok & ellipse_ok
    if altitude is not None:
        baro_ok = torch.abs(altitude - altitude[new_idx]) <= cfg.max_baro_difference
        # gate only pairs where BOTH have barometer data
        both = altitude_valid & altitude_valid[new_idx]
        ok = ok & (baro_ok | ~both)
    return ok


def _yaw_guess(yaws: torch.Tensor) -> torch.Tensor:
    """[B] yaws -> [B,4,4] rotations about z."""
    zeros = torch.zeros_like(yaws)
    w = torch.stack([zeros, zeros, yaws], dim=-1)
    return lie.se3_matrix(lie.so3_exp(w), torch.zeros_like(w))


def verify_loops_batch(
    new_xyz, new_mask, cand_xyz, cand_masks, yaws, valid,
    reg_cfg: RegistrationConfig, cfg: LoopConfig,
):
    """Registration-verify B candidates (loop_detector.cpp:219-233): align
    the new keyframe's cloud onto each candidate, gate on convergence and
    fitness (mean squared NN distance, pcl getFitnessScore). With
    cfg.use_sc_yaw_guess the scan-context yaw seeds each solve.

    new [N,3]/[N]; cand_xyz [B,N,3], cand_masks [B,N], yaws [B], valid [B].
    Returns (res with leading dim B, ok [B], best): best is the argmin of
    the fitness over passing candidates (0 when none passes, as argmin of
    all-inf)."""
    B = cand_xyz.shape[0]
    if cfg.use_sc_yaw_guess:
        guess = _yaw_guess(yaws.to(new_xyz.dtype))
    else:
        guess = torch.eye(4, dtype=new_xyz.dtype, device=new_xyz.device).expand(B, 4, 4)
    res = apdgicp.prepare_and_register(
        new_xyz.expand(B, -1, -1), new_mask.expand(B, -1), cand_xyz, cand_masks,
        guess.contiguous(), reg_cfg, device=new_xyz.device,
    )
    ok = res.converged & (res.fitness <= cfg.history_fitness_score) & valid
    best = torch.argmin(torch.where(ok, res.fitness, torch.inf))
    return res, ok, best


def verify_loop(new_xyz, new_mask, cand_xyz, cand_mask, reg_cfg: RegistrationConfig,
                cfg: LoopConfig, yaw_guess=None):
    """One candidate: (result, ok)."""
    yaws = torch.zeros(1, dtype=new_xyz.dtype, device=new_xyz.device)
    if yaw_guess is not None:
        yaws = yaws + yaw_guess
    valid = torch.ones(1, dtype=torch.bool, device=new_xyz.device)
    res, ok, _ = verify_loops_batch(
        new_xyz, new_mask, cand_xyz[None], cand_mask[None], yaws, valid, reg_cfg, cfg
    )
    return apdgicp._map(res, lambda t: t[0]), ok[0]


def odometry_check(T_lc_ij, odom_i, odom_j, num_between: int, cfg: LoopConfig):
    """LAMP-style odometry check (loop_detector.cpp:249-267):
    T_err = T_lc_ij (T_odom_j^-1 T_odom_i), per-edge error thresholds."""
    T_err = T_lc_ij @ (lie.se3_inverse(odom_j) @ odom_i)
    nb = float(max(num_between, 1))
    err_trans = torch.linalg.norm(T_err[:3, 3]) / nb
    err_rot = lie.rotation_angle(T_err[:3, :3]) / nb
    return (err_trans <= cfg.odom_check_trans_thresh) & (err_rot <= cfg.odom_check_rot_thresh)


def pairwise_check(T_lc_ij, odom_i, odom_j, prev_loop_old_odom, prev_loop_new_odom,
                   prev_T_lc, have_prev, cfg: LoopConfig):
    """Pairwise consistency against the previous loop (loop_detector.cpp:
    281-286): the new loop closes j (new) against i (old), the previous one
    k (its new) against l (its old); the cycle
        T_err = T(j<-i)_lc . T_odom(i<-l) . T_lc(l<-k) . T_odom(k<-j)
    telescopes to identity when both loops agree with the odometry.
    ``prev_T_lc`` is the stored previous measurement T(l<-k)."""
    T_odom_il = lie.se3_inverse(odom_i) @ prev_loop_old_odom
    T_odom_kj = lie.se3_inverse(prev_loop_new_odom) @ odom_j
    T_err = T_lc_ij @ T_odom_il @ prev_T_lc @ T_odom_kj
    ok = (torch.linalg.norm(T_err[:3, 3]) <= cfg.pairwise_check_trans_thresh) & (
        lie.rotation_angle(T_err[:3, :3]) <= cfg.pairwise_check_rot_thresh
    )
    return ok | ~torch.as_tensor(have_prev, device=T_err.device)
