"""Scan-matching odometry front end (port of
``rivslam_tpu/frontend/odometry.py``; scan_matching_odometry_nodelet.cpp).

``state', out = step(state, source, ...)``: guess composition, the
registration (``register_dispatch`` with one problem; K1 runs inside it
when ``use_pallas_correspondence`` is on, K2 on the exact path; on the
card it replays the Engine's ``GraphedRegistration``, whose
``core/cuda_graph.GraphCache`` captures on the first registration),
transform thresholding, keyframe gating and the target swap. Reference quirks kept:
- the ego-velocity translation prior keeps its previous value when the new
  delta exceeds max_egovel_cum (:369-371);
- max_acceptable_angle is compared in radians against a degrees-valued
  parameter (:513-515);
- the QUIRK fallback composes keyframe_pose * trans * radar_delta (:561-568).
"""

from __future__ import annotations

import dataclasses

import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import OdometryConfig, RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp


@dataclasses.dataclass(frozen=True)
class OdometryState:
    target: apdgicp.PreparedCloud  # current keyframe cloud (+covs)
    keyframe_pose: torch.Tensor  # [4,4] odom pose of the keyframe
    prev_trans: torch.Tensor  # [4,4] keyframe -> last frame
    egovel_trans: torch.Tensor  # [3] last accepted const-vel translation prior
    last_time: torch.Tensor  # [] seconds
    accum_distance: torch.Tensor  # [] total travel (keyframe_updater accumulator)
    keyframe_index: torch.Tensor  # [] int32


@dataclasses.dataclass(frozen=True)
class OdometryOutput:
    odom: torch.Tensor  # [4,4] odometry pose of this frame
    trans_delta: torch.Tensor  # [4,4] incremental odom vs previous frame
    is_keyframe: torch.Tensor  # [] bool
    thresholded: torch.Tensor  # [] bool
    reg: apdgicp.RegistrationResult
    accum_distance: torch.Tensor  # [] travel distance at this frame
    pred_error: torch.Tensor  # [4,4] inv(registration) @ motion-prediction guess


def init_state(cloud: apdgicp.PreparedCloud, t, dtype=torch.float32) -> OdometryState:
    """First frame: becomes the keyframe, odometry = identity (:431-445)."""
    dev = cloud.xyz.device
    eye = torch.eye(4, dtype=dtype, device=dev)
    return OdometryState(
        target=cloud,
        keyframe_pose=eye,
        prev_trans=eye,
        egovel_trans=torch.zeros(3, dtype=dtype, device=dev),
        last_time=torch.as_tensor(t, dtype=dtype, device=dev),
        accum_distance=torch.zeros((), dtype=dtype, device=dev),
        keyframe_index=torch.zeros((), dtype=torch.int32, device=dev),
    )


def transform_update(odom, imu_roll, imu_pitch, fusion_ratio: float) -> torch.Tensor:
    """Loose IMU roll/pitch complementary fusion (transformUpdate, :294-348):
    keep the odometry yaw, blend roll/pitch with the IMU's."""
    ypr = lie.ypr_from_rot(odom[:3, :3])
    roll_f = (1.0 - fusion_ratio) * ypr[2] + fusion_ratio * imu_roll
    pitch_f = (1.0 - fusion_ratio) * ypr[1] + fusion_ratio * imu_pitch
    zero = torch.zeros_like(ypr[0])
    Rz = lie.so3_exp(torch.stack([zero, zero, ypr[0]]))
    Ry = lie.so3_exp(torch.stack([zero, pitch_f, zero]))
    Rx = lie.so3_exp(torch.stack([roll_f, zero, zero]))
    return torch.cat([torch.cat([Rz @ Ry @ Rx, odom[:3, 3:]], dim=1), odom[3:]], dim=0)


def roll_pitch_from_gravity(acc_mean: torch.Tensor):
    """Roll/pitch from a (quasi-static) accelerometer gravity direction."""
    ax, ay, az = acc_mean[0], acc_mean[1], acc_mean[2]
    return torch.atan2(ay, az), torch.atan2(-ax, torch.sqrt(ay * ay + az * az))


def step(
    state: OdometryState,
    source: apdgicp.PreparedCloud,
    ego_vel: torch.Tensor,  # [3] m/s from REVE
    t: torch.Tensor,  # [] frame time, seconds
    odo_cfg: OdometryConfig,
    reg_cfg: RegistrationConfig,
    imu_roll=None,  # [] rad, gravity-derived (fusion)
    imu_pitch=None,
    imu_valid=None,  # [] bool
    graphs: apdgicp.GraphedRegistration | None = None,  # the registration's CUDA graphs (card)
) -> tuple[OdometryState, OdometryOutput]:
    dtype = state.keyframe_pose.dtype
    dev = state.keyframe_pose.device
    eye4 = torch.eye(4, dtype=dtype, device=dev)

    # --- constant-velocity translation prior (:361-374)
    ego_delta = ego_vel * (t - state.last_time)
    too_big = torch.sum(ego_delta**2) > odo_cfg.max_egovel_cum**2
    egovel_trans = torch.where(too_big, state.egovel_trans, ego_delta)
    egovel_cum = lie.se3_matrix(torch.eye(3, dtype=dtype, device=dev), egovel_trans)

    # --- guess and registration (:461-468)
    guess = state.prev_trans @ egovel_cum if odo_cfg.use_ego_vel else state.prev_trans
    reg = apdgicp.register_dispatch(source, state.target, guess, reg_cfg, device=dev, graphs=graphs)

    # non-convergence -> reuse the previous transform (:476-481)
    trans = torch.where(reg.converged, reg.T, state.prev_trans)
    odom_now = state.keyframe_pose @ trans

    # --- transform thresholding (:502-576, non-IMU branch)
    radar_delta = lie.se3_inverse(state.prev_trans) @ trans
    dx = torch.linalg.norm(radar_delta[:3, 3])
    da = lie.rotation_angle(radar_delta[:3, :3])  # radians, vs a degree param
    too_large = (dx > odo_cfg.max_acceptable_trans) | (da > odo_cfg.max_acceptable_angle_deg)
    thresholded = too_large & reg.converged & odo_cfg.enable_transform_thresholding
    if odo_cfg.thresholding_fallback == "EGOVEL":
        # substitute ego-velocity dead reckoning for the rejected delta
        fallback_trans = state.prev_trans @ egovel_cum
        odom_now = torch.where(thresholded, state.keyframe_pose @ fallback_trans, odom_now)
        prev_trans_new = torch.where(thresholded, fallback_trans, trans)
    else:  # QUIRK: reference parity (doubles the rejected delta)
        odom_now = torch.where(thresholded, state.keyframe_pose @ trans @ radar_delta, odom_now)
        prev_trans_new = trans  # both branches store trans (:561-568, :581-584)

    trans_delta = lie.se3_inverse(state.keyframe_pose @ state.prev_trans) @ odom_now

    # --- keyframe gating (keyframe_updater.hpp:38-71)
    rel = lie.se3_inverse(state.keyframe_pose) @ odom_now
    kf_dx = torch.linalg.norm(rel[:3, 3])
    kf_da = lie.rotation_angle(rel[:3, :3])
    is_kf = (kf_dx > odo_cfg.keyframe_delta_trans) | (kf_da > odo_cfg.keyframe_delta_angle)
    accum = state.accum_distance + torch.where(is_kf, kf_dx, 0.0)

    # --- loose IMU roll/pitch fusion, at keyframe acceptance, after the
    # keyframe decision (:584-596)
    if odo_cfg.enable_imu_fusion:
        if imu_roll is None or imu_pitch is None or imu_valid is None:
            raise ValueError("enable_imu_fusion needs imu_roll, imu_pitch and imu_valid")
        fused = transform_update(odom_now, imu_roll, imu_pitch, odo_cfg.imu_fusion_ratio)
        odom_now = torch.where(is_kf & imu_valid, fused, odom_now)

    # keyframe swap: target <- current cloud, prev_trans <- I (:590-601)
    new_target = apdgicp.PreparedCloud(
        *(torch.where(is_kf, a, b) for a, b in (
            (source.xyz, state.target.xyz), (source.mask, state.target.mask),
            (source.cov, state.target.cov),
        ))
    )
    new_state = OdometryState(
        target=new_target,
        keyframe_pose=torch.where(is_kf, odom_now, state.keyframe_pose),
        prev_trans=torch.where(is_kf, eye4, prev_trans_new),
        egovel_trans=egovel_trans,
        last_time=torch.as_tensor(t, dtype=dtype, device=dev),
        accum_distance=accum,
        keyframe_index=state.keyframe_index + is_kf.to(torch.int32),
    )
    out = OdometryOutput(
        odom=odom_now, trans_delta=trans_delta, is_keyframe=is_kf, thresholded=thresholded,
        reg=reg, accum_distance=accum, pred_error=lie.se3_inverse(trans) @ guess,
    )
    return new_state, out
