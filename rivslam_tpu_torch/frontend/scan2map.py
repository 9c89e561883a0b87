"""Scan-to-map (submap) odometry (port of ``rivslam_tpu/frontend/scan2map.py``;
the reference's enable_scan_to_map path, scan_matching_odometry_nodelet.cpp:
489-498, 606-622): keep the last ``max_submap_frames`` keyframe clouds,
merge them into the newest keyframe's frame, and register each scan
against that submap as well as scan-to-scan.

The submap is a fixed ring buffer [S, N] of keyframe clouds merged into one
masked cloud of capacity S*N (5120 at the presets' 5 x 1024), whose GICP
covariances are re-estimated on the merged cloud as the reference's
setInputTarget does. On the card the scan-to-map registration is a second
registration shape (N against S*N) and replays its own pair of the
Engine's registration graphs.

Divergence from the reference (deliberate, as in the JAX package): the
reference composes the per-keyframe transform as odom_i^-1 * odom_newest
(:608-611), which maps points the wrong way; this uses the correct
odom_newest^-1 * odom_i.

Divergence from the JAX module (same state bitwise): the JAX step
re-prepares the submap on every frame and keeps it with ``where(is_kf,
...)``, which keeps XLA's program branch-free. ``step`` reads the keyframe
flag on the host and rebuilds the ring buffer and the submap on keyframes
only, so a frame that is no keyframe does no S*N x S*N covariance prepare.

The scan-to-map registration and the submap rebuild carry
``torch.profiler.record_function`` scopes (``odometry.scan_to_map``,
``odometry.submap``) inside the Engine's ``engine.odometry``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import OdometryConfig, RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp, odometry


@dataclasses.dataclass(frozen=True)
class SubmapOdometryState:
    base: odometry.OdometryState  # scan-to-scan machinery
    prev_trans_s2m: torch.Tensor  # [4,4]
    keyframe_pose_s2m: torch.Tensor  # [4,4]
    kf_xyz: torch.Tensor  # [S,N,3] stored keyframe clouds (sensor frames)
    kf_mask: torch.Tensor  # [S,N]
    kf_pose: torch.Tensor  # [S,4,4] scan-to-scan odom pose of each stored kf
    kf_valid: torch.Tensor  # [S]
    target: apdgicp.PreparedCloud  # merged submap, capacity S*N


def init_state(cloud: apdgicp.PreparedCloud, t, odo_cfg: OdometryConfig,
               dtype=torch.float32) -> SubmapOdometryState:
    """First frame: the scan-to-scan state, and a submap holding the first
    cloud (in the ring's last slot, and in the merged cloud's first N)."""
    S = odo_cfg.max_submap_frames
    N = cloud.xyz.shape[0]
    dev = cloud.xyz.device
    base = odometry.init_state(cloud, t, dtype=dtype)
    kf_xyz = torch.zeros((S, N, 3), dtype=dtype, device=dev)
    kf_xyz[-1] = cloud.xyz
    kf_mask = torch.zeros((S, N), dtype=torch.bool, device=dev)
    kf_mask[-1] = cloud.mask
    kf_valid = torch.zeros(S, dtype=torch.bool, device=dev)
    kf_valid[-1] = True
    xyz = torch.zeros((S * N, 3), dtype=dtype, device=dev)
    xyz[:N] = cloud.xyz
    mask = torch.zeros(S * N, dtype=torch.bool, device=dev)
    mask[:N] = cloud.mask
    cov = torch.zeros((S * N, 3, 3), dtype=dtype, device=dev)
    cov[:N] = cloud.cov
    eye = torch.eye(4, dtype=dtype, device=dev)
    return SubmapOdometryState(
        base=base, prev_trans_s2m=eye, keyframe_pose_s2m=eye, kf_xyz=kf_xyz,
        kf_mask=kf_mask, kf_pose=eye.expand(S, 4, 4).clone(), kf_valid=kf_valid,
        target=apdgicp.PreparedCloud(xyz=xyz, mask=mask, cov=cov),
    )


def _build_submap(kf_xyz, kf_mask, kf_pose, kf_valid, newest_pose,
                  reg_cfg: RegistrationConfig) -> apdgicp.PreparedCloud:
    """Merge the stored keyframes into the newest keyframe's frame and
    re-estimate covariances (setInputTarget on the merged cloud, :617-620).
    The newest keyframe is included (the reference's loop stops one short):
    strictly more data."""
    S, N, _ = kf_xyz.shape
    rel = torch.einsum("ij,kjl->kil", lie.se3_inverse(newest_pose), kf_pose)  # [S,4,4]
    world = torch.einsum("kij,knj->kni", rel[:, :3, :3], kf_xyz) + rel[:, None, :3, 3]
    xyz = world.reshape(S * N, 3)
    mask = (kf_mask & kf_valid[:, None]).reshape(S * N)
    return apdgicp.prepare(xyz, mask, reg_cfg, device=xyz.device)


def _roll_in(buf: torch.Tensor, val) -> torch.Tensor:
    """The ring buffer shifted by one slot, ``val`` in its last slot."""
    out = torch.roll(buf, -1, dims=0)
    out[-1] = val
    return out


def step(
    state: SubmapOdometryState,
    source: apdgicp.PreparedCloud,
    ego_vel: torch.Tensor,
    t: torch.Tensor,
    odo_cfg: OdometryConfig,
    reg_cfg: RegistrationConfig,
    imu_roll=None,
    imu_pitch=None,
    imu_valid=None,
    graphs: apdgicp.GraphedRegistration | None = None,  # the registration's CUDA graphs (card)
) -> tuple[SubmapOdometryState, odometry.OdometryOutput]:
    base = state.base
    dtype, dev = base.keyframe_pose.dtype, base.keyframe_pose.device
    eye4 = torch.eye(4, dtype=dtype, device=dev)

    # the scan-to-scan step advances the keyframe machinery and gives the
    # guess. IMU fusion applies to the s2m pose only (the reference fuses
    # odom_s2m_now with scan-to-map on, :586-588), so it runs with fusion off
    s2s_cfg = dataclasses.replace(odo_cfg, enable_imu_fusion=False) if odo_cfg.enable_imu_fusion else odo_cfg
    new_base, s2s_out = odometry.step(base, source, ego_vel, t, s2s_cfg, reg_cfg, graphs=graphs)

    # the scan-to-map registration with the same guess composition (:489-498)
    ego_delta = ego_vel * (t - base.last_time)
    too_big = torch.sum(ego_delta**2) > odo_cfg.max_egovel_cum**2
    egovel_trans = torch.where(too_big, base.egovel_trans, ego_delta)
    egovel_cum = lie.se3_matrix(torch.eye(3, dtype=dtype, device=dev), egovel_trans)
    guess = base.prev_trans @ egovel_cum if odo_cfg.use_ego_vel else base.prev_trans
    with record_function("odometry.scan_to_map"):
        reg_m = apdgicp.register_dispatch(source, state.target, guess, reg_cfg, device=dev, graphs=graphs)
    trans_m = torch.where(reg_m.converged, reg_m.T, state.prev_trans_s2m)
    odom_m = state.keyframe_pose_s2m @ trans_m

    # transform thresholding on the s2m delta (:505-568)
    radar_delta = lie.se3_inverse(state.prev_trans_s2m) @ trans_m
    dx = torch.linalg.norm(radar_delta[:3, 3])
    da = lie.rotation_angle(radar_delta[:3, :3])
    too_large = (dx > odo_cfg.max_acceptable_trans) | (da > odo_cfg.max_acceptable_angle_deg)
    thresholded = too_large & reg_m.converged & odo_cfg.enable_transform_thresholding
    if odo_cfg.thresholding_fallback == "EGOVEL":
        fallback_trans = state.prev_trans_s2m @ egovel_cum
        odom_m = torch.where(thresholded, state.keyframe_pose_s2m @ fallback_trans, odom_m)
        trans_m = torch.where(thresholded, fallback_trans, trans_m)
    else:  # QUIRK: reference parity (:566-567)
        odom_m = torch.where(thresholded, state.keyframe_pose_s2m @ trans_m @ radar_delta, odom_m)

    is_kf = s2s_out.is_keyframe

    # loose IMU roll/pitch fusion on the s2m pose at keyframe acceptance
    # (transformUpdate(odom_s2m_now), :586-587)
    if odo_cfg.enable_imu_fusion:
        if imu_roll is None or imu_pitch is None or imu_valid is None:
            raise ValueError("enable_imu_fusion needs imu_roll, imu_pitch and imu_valid")
        fused = odometry.transform_update(odom_m, imu_roll, imu_pitch, odo_cfg.imu_fusion_ratio)
        odom_m = torch.where(is_kf & imu_valid, fused, odom_m)

    # on a keyframe: push the cloud into the ring buffer and rebuild the
    # submap in the new keyframe's frame (:606-622)
    kf_fields = (state.kf_xyz, state.kf_mask, state.kf_pose, state.kf_valid, state.target)
    if bool(is_kf):
        kf_xyz = _roll_in(state.kf_xyz, source.xyz)
        kf_mask = _roll_in(state.kf_mask, source.mask)
        kf_pose = _roll_in(state.kf_pose, s2s_out.odom)
        kf_valid = _roll_in(state.kf_valid, True)
        with record_function("odometry.submap"):
            target = _build_submap(kf_xyz, kf_mask, kf_pose, kf_valid, s2s_out.odom, reg_cfg)
        kf_fields = (kf_xyz, kf_mask, kf_pose, kf_valid, target)

    new_state = SubmapOdometryState(
        new_base,
        torch.where(is_kf, eye4, trans_m),
        torch.where(is_kf, odom_m, state.keyframe_pose_s2m),
        *kf_fields,
    )
    out = odometry.OdometryOutput(
        odom=odom_m,
        trans_delta=lie.se3_inverse(state.keyframe_pose_s2m @ state.prev_trans_s2m) @ odom_m,
        is_keyframe=is_kf,
        thresholded=thresholded,
        reg=reg_m,
        accum_distance=s2s_out.accum_distance,
        pred_error=lie.se3_inverse(trans_m) @ guess,
    )
    return new_state, out
