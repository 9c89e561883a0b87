"""The per-frame SLAM engine (port of the per-frame part of
``rivslam_tpu/pipeline.py``): preprocess -> REVE -> odometry -> floor ->
window backend, one radar frame at a time.

    eng = Engine(presets.get("cp"), device="cuda")
    outputs = datasets.replay(eng, seq)   # or eng.process_frame(...) per scan
    ts, poses = eng.trajectory()

Per frame (``_frame_step``): NaN/power filters, REVE ego velocity, dynamic
object removal, deskew, distance filter, voxel downsample, outlier removal,
floor detection with its fallback chain and under-floor removal, covariance
prepare, ``odometry.step`` (K1 inside the registration when
``use_pallas_correspondence`` is on) and ``slam.backend_step`` (K3 inside
the edge-information fitness). On the card every stage runs on the device;
the host reads a few flags per frame. The stages carry
``torch.profiler.record_function`` scopes (``engine.preprocess``,
``engine.odometry``, ``engine.backend``; ``backend.*`` inside it), which
cost nothing without a profiler and give ``profile_torch.py --engine`` its
per-stage host times.

Randomness. REVE and the floor detector pick their RANSAC hypotheses from
uniform scores (``frontend/reve.py``). The reference draws them from one
``jax.random`` key per frame, which torch cannot reproduce. The Engine
draws them on the CPU from a ``torch.Generator`` seeded by ``seed`` and
moves them to the device, so a CPU run and a card run of the port see the
same hypotheses. The one seam for the draw is the ``uniforms`` argument:
``uniforms(frame_index, shape) -> array in [0, 1)``, called per frame for
REVE's [ransac_iter, N] and then the floor's [ransac_iterations, N] scores
(the parity tests feed the JAX engine's own draws through it).

Not in this slice (ROADMAP.md, queue 1 item 8): the keyframe hook that
feeds the global graph (graph insertion, scan context, loop closure, GPS
and barometer priors). Without a loop or GPS edge it changes no per-frame
output and no trajectory pose, so the Engine keeps only the host-side
keyframe lists, and raises NotImplementedError for a configuration or a
frame that would need the graph. Scan-to-map odometry (item 5) raises too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from rivslam_tpu_torch.backend import slam
from rivslam_tpu_torch.core.config import EngineConfig
from rivslam_tpu_torch.core.device import resolve
from rivslam_tpu_torch.core.pointcloud import RadarCloud
from rivslam_tpu_torch.frontend import apdgicp, floor, odometry, reve
from rivslam_tpu_torch.ops import deskew, filters, voxel

_GRAPH = "needs the keyframe graph, not ported yet: see ROADMAP.md, queue 1 item 8"


@dataclasses.dataclass
class EngineState:
    """Mutable host-side engine state (device tensors inside)."""

    odo: odometry.OdometryState | None = None
    backend: slam.BackendState | None = None
    frame_idx: int = 0
    kf_count: int = 0
    floor_prev: torch.Tensor | None = None  # [4] fallback plane chain
    # host-side keyframe lists, kept for the keyframe-graph slice
    kf_stamps: list = dataclasses.field(default_factory=list)
    kf_accum: list = dataclasses.field(default_factory=list)
    kf_odom: list = dataclasses.field(default_factory=list)  # raw odometry 4x4
    trajectory: list = dataclasses.field(default_factory=list)  # (t, pose 4x4)


class Engine:
    """One SLAM run over a stream of radar frames. Call ``process_frame``
    per radar scan."""

    def __init__(self, cfg: EngineConfig = EngineConfig(), dtype=torch.float32, seed: int = 0,
                 device="cuda", uniforms=None):
        if cfg.loop.enable or cfg.loop.baro_z_prior:
            raise NotImplementedError(f"loop closure / barometer priors {_GRAPH}")
        if cfg.odometry.enable_scan_to_map:
            raise NotImplementedError(
                "scan-to-map odometry is not ported yet: see ROADMAP.md, queue 1 item 5"
            )
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve(device)
        self._generator = torch.Generator().manual_seed(seed)
        self._uniforms_fn = uniforms
        self.state = EngineState()

    def _uniforms(self, shape: tuple[int, int]) -> torch.Tensor:
        """RANSAC scores for this frame: the caller's ``uniforms`` seam, or
        the CPU generator. Drawn on the CPU, then moved to the device."""
        if self._uniforms_fn is not None:
            u = torch.tensor(np.asarray(self._uniforms_fn(self.state.frame_idx, shape)))
        else:
            u = torch.rand(shape, generator=self._generator)
        return u.to(self.device)

    def _preprocess(self, cloud: RadarCloud, ang_vel: torch.Tensor, prev_floor: torch.Tensor):
        c = self.cfg
        p = c.preprocess
        cl = filters.nan_filter(cloud)
        cl = filters.power_filter(cl, p.power_threshold)
        ego = reve.estimate_ego_velocity(cl, c.reve, self._uniforms((max(c.reve.ransac_iter, 1), cl.capacity)))
        # dynamic objects = RANSAC outliers (preprocessing_nodelet.cpp:766-774)
        dynamic_mask = cl.mask & ~ego.inlier_mask & ego.success
        if p.enable_dynamic_object_removal:
            cl = cl.and_mask(ego.inlier_mask | ~ego.success)
        if p.enable_deskew:
            cl = deskew.deskew(cl, ang_vel, scan_period=p.scan_period)
        if p.use_distance_filter:
            cl = filters.distance_filter(cl, p)
        if p.downsample_method == "VOXELGRID":
            cl = voxel.voxel_downsample(cl, p.downsample_resolution, cl.capacity)
        if p.outlier_removal_method == "RADIUS":
            cl = filters.radius_outlier_removal(cl, p.radius_radius, p.radius_min_neighbors)
        elif p.outlier_removal_method == "STATISTICAL":
            cl = filters.statistical_outlier_removal(cl, p.statistical_mean_k, p.statistical_stddev)
        elif p.outlier_removal_method == "BILATERAL":
            cl = filters.bilateral_filter(cl, p.bilateral_sigma_s, p.bilateral_sigma_r)
        fl = floor.detect_floor(
            cl.xyz, cl.mask, c.floor, self._uniforms((c.floor.ransac_iterations, cl.capacity))
        )
        # floor fallback chain (floor_detection_nodelet.cpp:100-130):
        # detected -> previous -> initial plane; under-floor removal clips
        # the odometry input against it (+tolerance margin)
        eff_floor = torch.where(fl.found, fl.coeffs, prev_floor)
        if p.enable_under_floor_removal:
            sd = cl.xyz @ eff_floor[:3] + eff_floor[3] + c.floor.floor_tolerance
            cl = cl.and_mask(sd > 0)
        prepared = apdgicp.prepare(cl.xyz, cl.mask, c.registration, device=self.device)
        return cl, ego, prepared, fl, dynamic_mask, eff_floor

    def _frame_step(self, cloud, ang_vel, stamp, imu_dts, imu_acc, imu_gyr, imu_mask):
        """preprocess -> odometry -> backend for one frame; the first frame
        initializes the odometry and the backend instead of matching."""
        c = self.cfg
        st = self.state
        with record_function("engine.preprocess"):
            cl, ego, prepared, fl, dynamic_mask, st.floor_prev = self._preprocess(
                cloud, ang_vel, st.floor_prev
            )
        oout = None
        if st.odo is None:
            # first frame (scan_matching_odometry_nodelet.cpp:431-445)
            st.odo = odometry.init_state(prepared, stamp, dtype=self.dtype)
            odom_pose = torch.eye(4, dtype=self.dtype, device=self.device)
            st.backend = slam.init_state(c.backend, c.imu, cl.capacity, self.dtype, self.device)
        else:
            imu_kw = {}
            if c.odometry.enable_imu_fusion:
                # roll/pitch from the frame's gravity direction
                w = imu_mask.to(imu_acc.dtype)
                acc_mean = (imu_acc * w[:, None]).sum(0) / torch.clamp_min(w.sum(), 1.0)
                roll, pitch = odometry.roll_pitch_from_gravity(acc_mean)
                imu_kw = dict(imu_roll=roll, imu_pitch=pitch, imu_valid=imu_mask.any())
            with record_function("engine.odometry"):
                st.odo, oout = odometry.step(
                    st.odo, prepared, ego.v, stamp, c.odometry, c.registration, **imu_kw
                )
            odom_pose = oout.odom
        frame = slam.BackendFrame(
            stamp=stamp, odom_R=odom_pose[:3, :3], odom_p=odom_pose[:3, 3],
            xyz=cl.xyz, mask=cl.mask, ego_vel=ego.v, ego_vel_cov=ego.sigma**2,
            imu_dts=imu_dts, imu_acc=imu_acc, imu_gyr=imu_gyr, imu_mask=imu_mask,
            floor=fl.coeffs, floor_valid=fl.found,
        )
        with record_function("engine.backend"):
            st.backend, bout = slam.backend_step(st.backend, frame, c.backend, c.imu)
        return ego, fl, dynamic_mask, oout, odom_pose, bout

    def process_frame(self, cloud: RadarCloud, stamp: float, imu_dts, imu_acc, imu_gyr,
                      imu_mask, altitude=None, gps_utm=None, gps_cov=None) -> dict:
        """Feed one radar frame (+ the IMU batch since the last). Returns the
        reference's output dict; ``loop_found`` is always False here.
        ``altitude`` feeds only the keyframe graph and is unused; a GPS fix
        raises NotImplementedError (it needs the graph)."""
        c = self.cfg
        st = self.state
        if gps_utm is not None and c.gps.enable:
            raise NotImplementedError(f"GPS priors {_GRAPH}")
        imu_acc, imu_gyr, imu_mask = np.asarray(imu_acc), np.asarray(imu_gyr), np.asarray(imu_mask)
        if c.imu.apply_extrinsics:
            # imuConverter parity (utility_radar.h:206-236)
            ext = np.asarray(c.imu.ext_rot, dtype=np.float64).reshape(3, 3)
            imu_acc = imu_acc @ ext.T
            imu_gyr = imu_gyr @ ext.T
        ang_vel = imu_gyr[np.argmax(imu_mask)] if imu_mask.any() else np.zeros(3)
        if st.floor_prev is None:
            # initial fallback plane (floor_detection_nodelet.cpp:122-127)
            st.floor_prev = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=self.dtype, device=self.device)

        def t(a, dtype=self.dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

        ego, fl, dynamic_mask, oout, odom_pose, bout = self._frame_step(
            cloud, t(ang_vel), t(stamp), t(imu_dts), t(imu_acc), t(imu_gyr), t(imu_mask, torch.bool),
        )
        if oout is None:
            is_kf, reg_ok, status = True, True, None
        else:
            is_kf = bool(oout.is_keyframe)
            reg_ok = bool(oout.reg.converged)
            status = self._scan_matching_status(oout)
        odom = odom_pose.cpu().numpy()
        if is_kf:
            st.kf_odom.append(odom)
            st.kf_stamps.append(stamp)
            st.kf_accum.append(float(st.odo.accum_distance))
            st.kf_count += 1
        st.frame_idx += 1
        pose = bout.pose.cpu().numpy()
        st.trajectory.append((stamp, pose))
        return {
            "odom": odom,
            "pose": pose,
            "is_keyframe": is_kf,
            "ego_velocity": ego.v.cpu().numpy(),
            "floor": fl.coeffs.cpu().numpy() if bool(fl.found) else None,
            "chi2": float(bout.chi2),
            "loop_found": False,
            "registration_ok": reg_ok,
            "dynamic_points": cloud.xyz.cpu().numpy()[dynamic_mask.cpu().numpy()],
            # ScanMatchingStatus parity (msg/ScanMatchingStatus.msg)
            "status": status,
        }

    @staticmethod
    def _scan_matching_status(oout) -> dict:
        reg = oout.reg
        return {
            "has_converged": bool(reg.converged),
            "matching_error": float(reg.error),
            "inlier_fraction": float(reg.fitness),
            "relative_pose": oout.trans_delta.cpu().numpy(),
            "num_correspondences": int(reg.num_correspondences),
            "prediction_labels": ["motion_prediction"],
            "prediction_errors": [oout.pred_error.cpu().numpy()],
        }

    def finalize(self) -> None:
        """No-op: the reference re-optimizes its global graph here, which
        this slice does not build."""

    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-frame trajectory (stamps [F], window-backend poses [F,4,4]).
        Without loop or GPS edges the reference returns these unchanged."""
        st = self.state
        ts = np.asarray([s for s, _ in st.trajectory])
        poses = np.stack([T for _, T in st.trajectory]) if ts.size else np.zeros((0, 4, 4))
        return ts, poses
