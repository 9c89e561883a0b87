"""Residuals of the backend's factors (port of
``rivslam_tpu/factors/residuals.py``).

Each function is batched over leading dims, so the same code serves the
whole window ([W, ...], for chi2) and one slot under ``torch.func.vmap``
(for the Jacobians). Edges (radar_graph_slam_nodelet.cpp:415-462):
EdgeGyroRW / EdgeAccRW, EdgeSE3 (relative odometry), EdgePose (unary
scan-match prior), EdgeSE3Interial (IMU preintegration),
EdgeRadar3DVelocity and EdgeSE3Plane; and the unary priors of the keyframe
graph (GPS, barometer, orientation, direction, navigation state).
"""

from __future__ import annotations

import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.navstate import GRAVITY
from rivslam_tpu_torch.factors import preintegration as pre
from rivslam_tpu_torch.factors.preintegration import mv


def _t(R: torch.Tensor) -> torch.Tensor:
    return R.transpose(-1, -2)


def bias_rw(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """EdgeGyroRW / EdgeAccRW (g2o_types.hpp:102-161): b2 - b1."""
    return b2 - b1


def relative_se3(R1, p1, R2, p2, R_meas, p_meas) -> torch.Tensor:
    """EdgeSE3, measurement T12 = T1^-1 T2:
    [log(R_meas^T R1^T R2); R1^T (p2 - p1) - p_meas]."""
    er = lie.so3_log(_t(R_meas) @ _t(R1) @ R2)
    ep = mv(_t(R1), p2 - p1) - p_meas
    return torch.cat([er, ep], dim=-1)


def pose_prior(R, p, R_meas, p_meas) -> torch.Tensor:
    """EdgePose unary prior (g2o_types.hpp:243-296): [log(R_m^T R); p - p_m]."""
    return torch.cat([lie.so3_log(_t(R_meas) @ R), p - p_meas], dim=-1)


def imu_preintegration(
    R1, p1, v1, bg1, ba1, R2, p2, v2, p_int: pre.Preintegration, gravity: float = GRAVITY
) -> torch.Tensor:
    """EdgeSE3Interial (edge_se3_interial.hpp:44-68), 9-dim (er, ev, ep)."""
    g = pre.gravity_vector(gravity, p1.dtype, p1.device)
    dt = p_int.dt[..., None]
    dR = pre.delta_rotation(p_int, bg1)
    dv = pre.delta_velocity(p_int, bg1, ba1)
    dp = pre.delta_position(p_int, bg1, ba1)
    er = lie.so3_log(_t(dR) @ _t(R1) @ R2)
    ev = mv(_t(R1), v2 - v1 + g * dt) - dv
    ep = mv(_t(R1), p2 - p1 - v1 * dt + 0.5 * g * dt * dt) - dp
    return torch.cat([er, ev, ep], dim=-1)


def velocity_prior(v, v_meas) -> torch.Tensor:
    """EdgeRadar3DVelocity (edge_3d_velocity.hpp:26-54): v - v_meas (world)."""
    return v - v_meas


def transform_plane(R, p, plane_w: torch.Tensor) -> torch.Tensor:
    """World plane (n, d), n.x + d = 0, into the sensor frame of pose (R, p):
    n_s = R^T n, d_s = d + n . p."""
    n = plane_w[..., :3]
    d = plane_w[..., 3:]
    return torch.cat([mv(_t(R), n), d + torch.sum(n * p, dim=-1, keepdim=True)], dim=-1)


def _tangent_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Smooth orthonormal basis of the plane orthogonal to unit n (Frisvad;
    smooth for n_z > -1, which holds for +z-pointing floor normals)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    a = -1.0 / (1.0 + torch.clamp_min(nz, -1.0 + 1e-6))
    b = nx * ny * a
    t1 = torch.stack([1.0 + nx * nx * a, b, -nx], dim=-1)
    t2 = torch.stack([b, 1.0 + ny * ny * a, -ny], dim=-1)
    return t1, t2


def se3_plane(R, p, plane_node_w: torch.Tensor, plane_meas_s: torch.Tensor) -> torch.Tensor:
    """EdgeSE3Plane (edge_se3_plane.hpp:41-48) as the reference re-designed
    it: the fixed world plane in the pose frame against the measured local
    plane, as normal deviation in the measured plane's tangent basis plus
    signed distance (3 dims)."""
    local = transform_plane(R, p, plane_node_w)
    n_est = local[..., :3] / torch.clamp_min(torch.linalg.norm(local[..., :3], dim=-1, keepdim=True), 1e-12)
    nm = plane_meas_s[..., :3]
    n_meas = nm / torch.clamp_min(torch.linalg.norm(nm, dim=-1, keepdim=True), 1e-12)
    t1, t2 = _tangent_basis(n_meas)
    return torch.stack(
        [torch.sum(t1 * n_est, dim=-1), torch.sum(t2 * n_est, dim=-1),
         local[..., 3] - plane_meas_s[..., 3]],
        dim=-1,
    )


def prior_xy(p, xy_meas) -> torch.Tensor:
    """EdgeSE3PriorXY (GPS)."""
    return p[..., :2] - xy_meas


def prior_xyz(p, xyz_meas) -> torch.Tensor:
    """EdgeSE3PriorXYZ (GPS + altitude)."""
    return p - xyz_meas


def prior_z(p, z_meas) -> torch.Tensor:
    """EdgeSE3PriorZ (barometer altitude anchor, edge_se3_priorz.hpp:1-76).
    The engine applies it as a z-only row of the keyframe graph's per-axis
    diagonal translation prior; this scalar form is its unit-testable twin."""
    return p[..., 2:3] - z_meas


def prior_quat(R, R_meas) -> torch.Tensor:
    """EdgeSE3PriorQuat: orientation prior."""
    return lie.so3_log(_t(R_meas) @ R)


def prior_vec(R, v_dir, v_meas) -> torch.Tensor:
    """EdgeSE3PriorVec: direction prior (e.g. gravity in the IMU frame)."""
    return mv(_t(R), v_dir) - v_meas


def prior_navstate(R, p, v, bg, ba, R0, p0, v0, bg0, ba0) -> torch.Tensor:
    """EdgePriorPoseNavState (g2o_types.hpp:165-239), 15-dim."""
    er = lie.so3_log(_t(R0) @ R)
    return torch.cat([er, p - p0, v - v0, bg - bg0, ba - ba0], dim=-1)
