"""Sliding-window SLAM back end (port of ``rivslam_tpu/backend/slam.py``;
apps/radar_graph_slam_nodelet.cpp:207-587).

Every frame enters the 6-frame window of {pose, velocity, biases}, which is
rebuilt and re-optimized each frame; failure detection resets
biases/velocity (:489-522, 1351-1371). ``backend_step`` rolls the window,
preintegrates the frame's IMU batch, takes the new odometry edge's
information from the registration fitness (K3 inside
``factors/infomat``), rebuilds the factors and runs the window LM. On the
card the Engine hands it ``BackendGraphs``: the preintegration and the
window solve's outer iteration then replay CUDA graphs (the solve's
captured at Engine construction, the preintegration's for each IMU buffer
length on its first frame), and the CPU runs the same functions eagerly.
Reference quirks kept: initial biases set to the noise densities with
bg/ba swapped (:180-186), the ego velocity rotated by the PRE-optimize
attitude each rebuild (:432), the previous frame's floor coefficients as
the fixed world plane node (:448-459).
"""

from __future__ import annotations

import dataclasses

import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import BackendConfig, ImuConfig
from rivslam_tpu_torch.core.navstate import NavState
from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.factors import infomat
from rivslam_tpu_torch.factors import preintegration as pre
from rivslam_tpu_torch.factors.preintegration import mv
from rivslam_tpu_torch.solver import window as win

DEFAULT_PLANE = (0.0, 0.0, 1.0, 0.5)  # nodelet:453
FLOOR_EDGE_STDDEV = 1.0e-6  # nodelet:128


@dataclasses.dataclass(frozen=True)
class BackendFrame:
    """One synced (odom, cloud, floor, twist, imu-batch) input frame."""

    stamp: torch.Tensor  # []
    odom_R: torch.Tensor  # [3,3] scan-matching odometry pose
    odom_p: torch.Tensor  # [3]
    xyz: torch.Tensor  # [N,3]
    mask: torch.Tensor  # [N]
    ego_vel: torch.Tensor  # [3] body-frame ego velocity (REVE)
    ego_vel_cov: torch.Tensor  # [3] diagonal covariance of the twist
    imu_dts: torch.Tensor  # [K]
    imu_acc: torch.Tensor  # [K,3]
    imu_gyr: torch.Tensor  # [K,3]
    imu_mask: torch.Tensor  # [K]
    floor: torch.Tensor  # [4] sensor-frame plane coeffs
    floor_valid: torch.Tensor  # []


@dataclasses.dataclass(frozen=True)
class BackendState:
    frame_mask: torch.Tensor  # [W]
    stamps: torch.Tensor  # [W]
    odom_R: torch.Tensor  # [W,3,3]
    odom_p: torch.Tensor  # [W,3]
    xyz: torch.Tensor  # [W,N,3]
    cloud_mask: torch.Tensor  # [W,N]
    nav: win.WindowState  # optimized states
    preint: pre.Preintegration  # [W] slot i integrates (i-1, i)
    preint_info: torch.Tensor  # [W,9,9]
    rel_R: torch.Tensor  # [W,3,3] cached odom relative measurement
    rel_p: torch.Tensor  # [W,3]
    rel_info: torch.Tensor  # [W,6,6] cached fitness-based info
    ego_vel: torch.Tensor  # [W,3] body-frame twist
    vel_info: torch.Tensor  # [W,3]
    floor: torch.Tensor  # [W,4]
    floor_valid: torch.Tensor  # [W]
    trans_aftmapped: torch.Tensor  # [4,4] latest optimized map pose


@dataclasses.dataclass(frozen=True)
class BackendOutput:
    pose: torch.Tensor  # [4,4] optimized pose of the newest frame (map frame)
    pose_incremental: torch.Tensor  # [4,4] delta vs previous aftmapped
    trans_odom2map: torch.Tensor  # [4,4] correction odom->map
    chi2: torch.Tensor
    iterations: int
    failure: torch.Tensor  # [] bool (failure detection fired on newest frame)


def _initial_biases(imu_cfg: ImuConfig, dtype, device):
    # nodelet:180-186, with its swapped assignment
    b_a_in = torch.full((3,), imu_cfg.acc_bias_noise, dtype=dtype, device=device)
    b_g_in = torch.full((3,), imu_cfg.gyr_bias_noise, dtype=dtype, device=device)
    return b_g_in, b_a_in


def init_state(cfg: BackendConfig, imu_cfg: ImuConfig, cloud_capacity: int,
               dtype=torch.float32, device="cpu") -> BackendState:
    W, N = cfg.window_size, cloud_capacity
    kw = dict(dtype=dtype, device=device)
    b_g_in, b_a_in = _initial_biases(imu_cfg, dtype, device)
    eye = torch.eye(3, **kw).expand(W, 3, 3)
    preint = pre.Preintegration.identity(dtype, device)
    return BackendState(
        frame_mask=torch.zeros(W, dtype=torch.bool, device=device),
        stamps=torch.zeros(W, **kw),
        odom_R=eye,
        odom_p=torch.zeros((W, 3), **kw),
        xyz=torch.zeros((W, N, 3), **kw),
        cloud_mask=torch.zeros((W, N), dtype=torch.bool, device=device),
        nav=win.WindowState(
            R=eye, p=torch.zeros((W, 3), **kw), v=torch.zeros((W, 3), **kw),
            bg=b_g_in.expand(W, 3), ba=b_a_in.expand(W, 3),
        ),
        preint=pre.Preintegration(*(a.expand((W,) + a.shape) for a in preint.astuple())),
        preint_info=torch.eye(9, **kw).expand(W, 9, 9),
        rel_R=eye,
        rel_p=torch.zeros((W, 3), **kw),
        rel_info=torch.eye(6, **kw).expand(W, 6, 6),
        ego_vel=torch.zeros((W, 3), **kw),
        vel_info=torch.full((W, 3), 10.0, **kw),
        floor=torch.tensor(DEFAULT_PLANE, **kw).expand(W, 4),
        floor_valid=torch.zeros(W, dtype=torch.bool, device=device),
        trans_aftmapped=torch.eye(4, **kw),
    )


def bias_information(imu_cfg: ImuConfig) -> tuple[float, float]:
    """The bias random-walk factors' information (gyro, accel)."""
    return (1.0 / imu_cfg.gyr_noise**2, 1.0 / imu_cfg.acc_noise**2)


class BackendGraphs:
    """The backend's fixed-shape pieces as CUDA graphs (card only): the
    window solve for ``cfg.window_size`` slots, ``dtype`` and
    ``cfg.use_schur``, captured here, and the IMU preintegration, captured
    for each buffer length the first time it comes. A capture failure
    raises."""

    def __init__(self, cfg: BackendConfig, imu_cfg: ImuConfig, dtype, device):
        self.preintegrate = pre.GraphedPreintegrate(imu_cfg.gyr_noise, imu_cfg.acc_noise, dtype, device)
        self.solve = win.GraphedSolver(
            cfg, bias_information(imu_cfg), cfg.window_size, dtype, device, cfg.use_schur
        )


def _push(a: torch.Tensor, new) -> torch.Tensor:
    """Roll the window by one and put ``new`` in the last slot."""
    return torch.cat([a[1:], torch.as_tensor(new, dtype=a.dtype, device=a.device)[None]])


def backend_step(state: BackendState, frame: BackendFrame, cfg: BackendConfig,
                 imu_cfg: ImuConfig, graphs: BackendGraphs | None = None,
                 ) -> tuple[BackendState, BackendOutput]:
    dtype = state.odom_p.dtype
    dev = state.odom_p.device
    W = cfg.window_size
    is_first = ~torch.any(state.frame_mask)

    # --- preintegrate with the last optimized biases (nodelet:347-372)
    last = [a[-1] for a in state.nav.astuple()]  # R, p, v, bg, ba
    imu = (frame.imu_dts, frame.imu_acc, frame.imu_gyr, frame.imu_mask, last[3], last[4])
    with timing.span("backend.preintegrate"):
        if graphs is None:
            p_int = pre.preintegrate(*imu, imu_cfg.gyr_noise, imu_cfg.acc_noise)
        else:
            p_int = graphs.preintegrate(*imu)
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    preint_info = torch.linalg.inv_ex(p_int.cov + 1e-10 * eye9)[0] * cfg.inertial_weight

    # --- predicted navstate for the new frame (nodelet:375-378)
    pred = pre.predict(NavState(state.stamps[-1], *last), p_int, imu_cfg.gravity)
    b_g_in, b_a_in = _initial_biases(imu_cfg, dtype, dev)
    # first frame: seed from odometry (nodelet:300-312)
    new_R = torch.where(is_first, frame.odom_R, pred.R)
    new_p = torch.where(is_first, frame.odom_p, pred.p)
    new_v = torch.where(is_first, torch.zeros(3, dtype=dtype, device=dev), pred.v)
    new_bg = torch.where(is_first, b_g_in, pred.bg)
    new_ba = torch.where(is_first, b_a_in, pred.ba)

    # --- relative odometry measurement + fitness info for the new pair
    rel_R_new = frame.odom_R.T @ state.odom_R[-1]  # T_this^-1 T_prev (nodelet:418)
    rel_p_new = mv(frame.odom_R.T, state.odom_p[-1] - frame.odom_p)
    with timing.span("backend.information"):
        rel_info_new = infomat.calc_information_matrix(
            frame.xyz, frame.mask, state.xyz[-1], state.cloud_mask[-1],
            lie.se3_matrix(rel_R_new, rel_p_new), cfg,
        )

    # --- velocity info from the twist covariance (nodelet:434-444)
    cov_ok = torch.all(frame.ego_vel_cov > 0)
    vel_info_new = torch.where(cov_ok, 0.01 / torch.clamp_min(frame.ego_vel_cov, 1e-12), 10.0)

    # --- roll the window and insert the new frame at slot W-1
    default_plane = torch.tensor(DEFAULT_PLANE, dtype=dtype, device=dev)
    st = BackendState(
        frame_mask=_push(state.frame_mask, True),
        stamps=_push(state.stamps, frame.stamp),
        odom_R=_push(state.odom_R, frame.odom_R),
        odom_p=_push(state.odom_p, frame.odom_p),
        xyz=_push(state.xyz, frame.xyz),
        cloud_mask=_push(state.cloud_mask, frame.mask),
        nav=win.WindowState(*(
            _push(a, b) for a, b in zip(state.nav.astuple(), (new_R, new_p, new_v, new_bg, new_ba))
        )),
        preint=pre.Preintegration(*(
            _push(a, b) for a, b in zip(state.preint.astuple(), p_int.astuple())
        )),
        preint_info=_push(state.preint_info, preint_info),
        rel_R=_push(state.rel_R, rel_R_new),
        rel_p=_push(state.rel_p, rel_p_new),
        rel_info=_push(state.rel_info, rel_info_new),
        ego_vel=_push(state.ego_vel, frame.ego_vel),
        vel_info=_push(state.vel_info, vel_info_new),
        floor=_push(state.floor, torch.where(frame.floor_valid, frame.floor, default_plane)),
        floor_valid=_push(state.floor_valid, True),
        trans_aftmapped=state.trans_aftmapped,
    )

    # --- build the factors (nodelet:389-462)
    vel_meas_world = torch.einsum("wij,wj->wi", st.nav.R, st.ego_vel)  # pre-opt R (quirk)
    factors = win.WindowFactors(
        frame_mask=st.frame_mask,
        rel_R=st.rel_R,
        rel_p=st.rel_p,
        rel_info=st.rel_info,
        prior_R=st.odom_R,
        prior_p=st.odom_p,
        prior_info=st.rel_info,  # same info for EdgePose (nodelet:422-424)
        preint=st.preint,
        preint_info=st.preint_info,
        vel_meas=vel_meas_world,
        vel_info=st.vel_info,
        plane_node=torch.roll(st.floor, 1, dims=0),  # previous frame's coeffs as node
        plane_meas=st.floor,
        plane_info=torch.full((W,), 1.0 / FLOOR_EDGE_STDDEV, dtype=dtype, device=dev),
        plane_valid=st.floor_valid,
    )
    with timing.span("backend.window_solve"):
        if graphs is None:
            nav_opt, chi2, iters = win.solve_window(
                st.nav, factors, cfg, bias_information(imu_cfg), use_schur=cfg.use_schur
            )
        else:
            nav_opt, chi2, iters = graphs.solve(st.nav, factors)

    # --- failure detection + resets (nodelet:489-522, 1351-1371)
    bad = (
        (torch.linalg.norm(nav_opt.v, dim=-1) > cfg.max_velocity)
        | (torch.linalg.norm(nav_opt.ba, dim=-1) > cfg.max_bias)
        | (torch.linalg.norm(nav_opt.bg, dim=-1) > cfg.max_bias)
    )[:, None]
    nav_fixed = win.WindowState(
        R=nav_opt.R,
        p=torch.where(bad, st.odom_p, nav_opt.p),
        v=torch.where(bad, vel_meas_world, nav_opt.v),
        bg=torch.where(bad, b_g_in, nav_opt.bg),
        ba=torch.where(bad, b_a_in, nav_opt.ba),
    )
    pose = lie.se3_matrix(nav_fixed.R[-1], nav_fixed.p[-1])
    odom_T = lie.se3_matrix(st.odom_R[-1], st.odom_p[-1])
    out = BackendOutput(
        pose=pose,
        pose_incremental=lie.se3_inverse(state.trans_aftmapped) @ pose,
        trans_odom2map=pose @ lie.se3_inverse(odom_T),
        chi2=chi2,
        iterations=iters,
        failure=bad[-1, 0],
    )
    return dataclasses.replace(st, nav=nav_fixed, trans_aftmapped=pose), out
