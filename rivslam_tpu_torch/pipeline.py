"""The SLAM engine (port of ``rivslam_tpu/pipeline.py``): preprocess -> REVE
-> odometry -> floor -> window backend per radar frame, and on keyframes the
global keyframe graph with loop closure.

    eng = Engine(presets.get("cp"), device="cuda")
    outputs = datasets.replay(eng, seq)   # or eng.process_frame(...) per scan
    ts, poses = eng.trajectory()          # loop-corrected (corrected=True)

    rep = eng.replay_sequence(datasets.stack_sequence(seq))  # no loop stage

``replay_sequence`` runs the frame step over a whole stacked sequence with
its inputs and every frame's RANSAC scores uploaded once and its outputs
kept on the device until the end (the reference's one-``lax.scan`` replay);
``replay_fleet`` runs B sequences so, one after another.

Per frame (``_frame_step``): NaN/power filters, REVE ego velocity, dynamic
object removal, deskew, distance filter, voxel downsample, outlier removal,
floor detection with its fallback chain and under-floor removal, covariance
prepare, ``odometry.step`` (K1 inside the fast registration when
``use_pallas_correspondence`` is on, K2 inside the exact one) and
``slam.backend_step`` (K3 inside the edge-information fitness). On the card
every stage runs on the device; the backend's window solve is one launch of
the window kernel and one host read, and CUDA graphs replay the RANSAC
draw, the IMU preintegration and the odometry's registration (one outer LM
iteration, the final correspondence step; ``reg_graphs``), each captured on
first use of its shape by a ``core/cuda_graph.GraphCache``; the host reads
one flag per outer iteration of the registration, and a few more per
frame. The CPU runs the same code eagerly.

With ``odometry.enable_scan_to_map`` (the nyl and garden presets) the
odometry is ``scan2map.step``: the scan-to-scan step, then a second
registration of the scan against the merged submap of the last keyframes
(on the card a second registration shape, N against 5 N, with its own
graph pair), the submap rebuilt on keyframes only.

Per keyframe (``_on_keyframe``): the keyframe joins the global graph with
its odometry edge (its information from a K3 fitness pass), GPS and
barometer priors, and the scan-context database, always on the frame's
thread; with ``loop.enable``, loop detection runs on a snapshot of that
state: candidate prefilter, scan-context match, registration verification
(the engine's own registration: K1 or K2), odometry and pairwise checks, and
on acceptance the loop edge and a global solve (block-Schur by default). A
full graph is compacted. ``trajectory(corrected=True)`` spreads the graph's
correction over every frame.

Loop detection runs inline, or with ``loop.async_loop`` on a worker thread
(the reference's wall-timer architecture, radar_graph_slam_nodelet.cpp:177,
652-778): one job in flight, a keyframe that finds the worker busy is
skipped (``loop_stats["skipped_worker_busy"]``), and the worker's detection
and global solve merge into the live graph at the next frame
(``_apply_pending_loops``): keyframes the worker saw take its solved poses,
later ones re-chain their odometry edges onto them (``_merge_chain``).
``drain_loops`` waits for the worker; draining after every frame gives the
synchronous run bitwise. A worker exception is raised on the frame's
thread; a result computed before a compaction is dropped. On the card the
worker runs on its own CUDA stream: it waits on an event recorded on the
frame's stream when the snapshot is taken, the frame's stream waits on one
the worker records before a result is read, and tensors used on the other
stream are marked with ``record_stream``; each job holds
``core/cuda_graph.LOCK``, which every graph capture takes too, and its
kernel launches count as ``worker_launches``. The worker captures no CUDA
graph (``GraphCache``'s rule): a verification graph that falls due there
(``frontend/apdgicp``'s module store) is captured on the frame's thread
when it merges the job (``apdgicp.capture_deferred``), and the worker
replays it from then on.

The stages are spans of the Engine's tracer, ``timers``
(``eval/timing.StageTimers``; pass ``timers=`` to share one switched on
before the Engine is built, so that its graph captures are traced too):
each frame is one ``engine.process_frame`` with ``engine.merge_loops``,
``engine.inputs``, ``engine.preprocess`` (``preprocess.draw``,
``preprocess.reve``, ``preprocess.filters``, ``preprocess.floor``,
``apdgicp.prepare``), ``engine.odometry``, ``engine.backend`` (``backend.*``
inside), ``engine.outputs`` and, on keyframes, ``engine.keyframe``
(``keyframe.insert``, ``engine.loop_detection``, ``engine.global_solve``).
A span is a ``torch.profiler.record_function`` scope while a profiler
records (``profile_torch.py --engine``'s per-stage host times); the
``frame_step``, ``loop``, ``graph_opt``, ``graph_opt_async`` and
``loop_detect_async`` samples are always kept; with ``timers.on()`` the
tracer also keeps every span's record, each frame's per-stage host ms and
its host syncs, graph captures and replays (``timers.frames()``).

Randomness. REVE and the floor detector pick their RANSAC hypotheses from
uniform scores (``frontend/reve.py``). The reference draws them from its
``jax.random`` key chain, and so does the port (``core/prng.py``, JAX's
threefry bit for bit): ``Engine(seed)`` holds ``key(seed)``, each
``process_frame`` splits it once, ``(key, k1) = split(key)``, frame 0
included, and draws ``uniform(k1, (max(R_reve, R_floor), N))`` in the
Engine's dtype on its device, REVE taking its first ``R_reve`` rows and the
floor its first ``R_floor`` (the reference draws each from k1, and a draw's
leading rows are the smaller draw). So a port Engine with seed s tests the
hypotheses of a JAX Engine with seed s, in float32 those of a JAX run with
``jax_enable_x64`` off (JAX draws float64 when x64 is on), and a card run
the CPU run's. The replay draws every frame's scores from the reference's
``split_chain`` in one call; the fleet folds sequence b into the call's
base key, as the reference does. The tests' seam for the draw is the
``uniforms`` argument: ``uniforms(frame_index, shape) -> array in [0, 1)``,
called per frame for REVE's [ransac_iter, N] and then the floor's
[ransac_iterations, N] scores in place of the key's draw; the replay calls
it with the frame's index in the sequence, the fleet with ``sequence=b`` as
well.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import queue
import threading
import time

import numpy as np
import torch

from rivslam_tpu_torch.backend import slam
from rivslam_tpu_torch.core import cuda_graph, lie, prng
from rivslam_tpu_torch.core.config import EngineConfig
from rivslam_tpu_torch.core.device import resolve
from rivslam_tpu_torch.core.pointcloud import RadarCloud
from rivslam_tpu_torch.eval.timing import StageTimers
from rivslam_tpu_torch.factors import infomat
from rivslam_tpu_torch.frontend import apdgicp, floor, odometry, reve, scan2map
from rivslam_tpu_torch.loop import block_schur, detector, global_graph, scancontext
from rivslam_tpu_torch.ops import cuda_build, deskew, filters, voxel


def _se3_log_np(T: np.ndarray) -> np.ndarray:
    """Host-side SE(3) log, [omega, rho] (float64 numpy, for the trajectory
    correction)."""
    R = T[:3, :3]
    cos = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(cos)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-9:
        w = 0.5 * vee
    elif th > np.pi - 1e-4:
        # sin(th) -> 0 kills the vee form; recover the axis from the
        # symmetric part: R + R^T - (tr R - 1) I = 2 (1 - cos th) a a^T
        S = R + R.T - (np.trace(R) - 1.0) * np.eye(3)
        col = S[:, int(np.argmax(np.diag(S)))]
        a = col / np.linalg.norm(col)
        if a @ vee < 0.0:
            a = -a
        w = th * a
    else:
        w = th / (2.0 * np.sin(th)) * vee
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    t2 = w @ w
    if t2 < 1e-18:
        Vinv = np.eye(3) - 0.5 * W
    else:
        t = np.sqrt(t2)
        Vinv = np.eye(3) - 0.5 * W + (1.0 - t * np.cos(t * 0.5) / (2.0 * np.sin(t * 0.5))) / t2 * (W @ W)
    return np.concatenate([w, Vinv @ T[:3, 3]])


def _se3_exp_np(xi: np.ndarray) -> np.ndarray:
    w, rho = xi[:3], xi[3:]
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    t2 = w @ w
    T = np.eye(4)
    if t2 < 1e-18:
        R = np.eye(3) + W
        V = np.eye(3) + 0.5 * W
    else:
        t = np.sqrt(t2)
        R = np.eye(3) + np.sin(t) / t * W + (1 - np.cos(t)) / t2 * (W @ W)
        V = np.eye(3) + (1 - np.cos(t)) / t2 * W + (t - np.sin(t)) / (t2 * t) * (W @ W)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def _with_rows(g, k: int, **rows):
    """A copy of dataclass ``g`` whose named tensor fields have row k set."""
    upd = {}
    for name, value in rows.items():
        t = getattr(g, name).clone()
        t[k] = value
        upd[name] = t
    return dataclasses.replace(g, **upd)


def _tensors(obj):
    """Every tensor in a nest of dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _merge_chain(live_R, live_p, solved_R, solved_p, rel_R, rel_p, k_snap: int, count: int):
    """Merge a worker's solved pose set into the live graph: nodes <= k_snap
    take the worker's estimates; the keyframes inserted since the snapshot
    (k_snap < i < count) re-chain their raw odometry deltas onto them (the
    trans_odom2map retarget, radar_graph_slam_nodelet.cpp:222-247, applied
    at merge time); slots >= count keep their live values. The reference
    scans all K slots; only the inserted keyframes differ from a copy, so
    the host loops over those alone (the same arithmetic for them)."""
    R, p = solved_R.clone(), solved_p.clone()
    for i in range(k_snap + 1, count):
        Rp = R[i - 1]
        R[i] = Rp @ rel_R[i]
        p[i] = Rp @ rel_p[i] + p[i - 1]
    R[count:] = live_R[count:]
    p[count:] = live_p[count:]
    return R, p


def _imu_in_radar_frame(imu_cfg, acc, gyr, mask) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One frame's IMU batch on the host in the radar frame: acc and gyr
    rotated by the IMU extrinsic with ``imu.apply_extrinsics`` (imuConverter
    parity, utility_radar.h:206-236; in float64), and the angular velocity
    that deskews the scan, the first valid gyro sample (zero without one)."""
    acc, gyr, mask = np.asarray(acc), np.asarray(gyr), np.asarray(mask)
    if imu_cfg.apply_extrinsics:
        ext = np.asarray(imu_cfg.ext_rot, dtype=np.float64).reshape(3, 3)
        acc, gyr = acc @ ext.T, gyr @ ext.T
    return acc, gyr, gyr[np.argmax(mask)] if mask.any() else np.zeros(3)


@dataclasses.dataclass
class EngineState:
    """Mutable host-side engine state (device tensors inside)."""

    odo: odometry.OdometryState | None = None
    backend: slam.BackendState | None = None
    scdb: scancontext.ScanContextDB | None = None
    graph: global_graph.PoseGraph | None = None
    frame_idx: int = 0
    kf_count: int = 0  # keyframes in the global graph
    last_loop_accum: float = 0.0
    prev_loop: dict | None = None
    floor_prev: torch.Tensor | None = None  # [4] fallback plane chain
    kf_clouds: list = dataclasses.field(default_factory=list)  # per-kf (xyz, mask)
    kf_stamps: list = dataclasses.field(default_factory=list)
    kf_accum: list = dataclasses.field(default_factory=list)
    kf_alt: list = dataclasses.field(default_factory=list)  # barometer altitude (nan if absent)
    kf_odom: list = dataclasses.field(default_factory=list)  # raw odometry 4x4 (device)
    zero_utm: np.ndarray | None = None  # UTM origin = first accepted GPS fix
    baro_zero: float | None = None  # altitude origin = first keyframe reading
    gps_kf_since_solve: int = 0  # GPS-tagged keyframes since the last solve
    trajectory: list = dataclasses.field(default_factory=list)  # (t, pose 4x4)
    compact_epoch: int = 0  # bumped by each compaction: an async loop result
    # from before one carries stale node indices and is dropped


class Engine:
    """One SLAM run over a stream of radar frames. Call ``process_frame``
    per radar scan."""

    def __init__(self, cfg: EngineConfig = EngineConfig(), dtype=torch.float32, seed: int = 0,
                 device="cuda", uniforms=None, timers: StageTimers | None = None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve(device)
        self.key = prng.key(seed)  # the reference's key chain (core/prng.py)
        self._uniforms_fn = uniforms
        self.state = EngineState()
        self.timers = StageTimers() if timers is None else timers
        # on the card the backend's preintegration replays CUDA graphs and
        # its window solve launches the window kernel; the CPU runs both eagerly
        on_card = self.device.type == "cuda"
        self.graphs = slam.BackendGraphs(cfg.backend, cfg.imu, dtype, self.device) if on_card else None
        # and so does the odometry's registration, captured on its first frame
        self.reg_graphs = apdgicp.GraphedRegistration() if on_card else None
        # and the frame's RANSAC draw, one graph per cloud capacity (_frame_draw)
        self._draw_graphs = cuda_graph.GraphCache(lambda shape: cuda_graph.Graphed(
            f"RANSAC draw {shape}", lambda w: prng.uniform_stack(w, shape, self.dtype, self.device)[0],
            [torch.zeros((1, 2), dtype=torch.int64, device=self.device)]))
        # the asynchronous loop worker (loop.async_loop): one job in flight,
        # results merged on the frame's thread at the next frame
        self._loop_thread = None
        self._loop_queue = None
        self._loop_stream = None  # the worker's CUDA stream (card)
        self._loop_results: list = []
        self._loop_lock = threading.Lock()
        self._loop_busy = False
        self._loop_skipped = 0  # keyframes skipped while the worker was busy
        self._loop_error: BaseException | None = None
        # loop-pipeline outcome counts, as the reference's
        self.loop_stats = {
            "detections_run": 0,        # keyframes that entered detection
            "skipped_worker_busy": 0,   # async worker overrun (= _loop_skipped)
            "no_candidate": 0,          # prefilter/SC retrieval empty
            "rejected_verify": 0,       # registration fitness gate
            "rejected_odom_check": 0,   # LAMP odometry check
            "rejected_pairwise": 0,     # pairwise consistency vs the previous loop
            "pairwise_checked": 0,      # checks run WITH a real previous loop
            "accepted": 0,              # loop edges committed to the graph
            "dropped_capacity": 0,      # accepted but loop slots exhausted
            "sc_dropped_capacity": 0,   # descriptor DB full at insert (stays 0:
                                        # compaction runs first)
        }

    def _upload(self, a, dtype=None) -> torch.Tensor:
        """A host array on the Engine's device, in ``dtype`` or the Engine's."""
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype).to(self.device)

    def _draw_shapes(self, n: int) -> tuple[tuple[int, int], tuple[int, int]]:
        """The shapes of one frame's RANSAC scores, in the order they are
        drawn: REVE's, then the floor detector's, for a cloud of n points."""
        c = self.cfg
        return (max(c.reve.ransac_iter, 1), n), (c.floor.ransac_iterations, n)

    def _draw_sequence(self, keys: list, n: int, uniforms, start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """The RANSAC scores of the F frames whose subkeys are ``keys``, for
        n points: ([F, R_reve, n], [F, R_floor, n]). One draw of
        [max(R_reve, R_floor), n] per key, in one call on the Engine's
        device, REVE's the leading rows of the floor's; or, with the
        ``uniforms`` seam, ``uniforms(start + i, shape)`` for frame i in
        ``process_frame``'s order, uploaded at once."""
        shapes = self._draw_shapes(n)
        if uniforms is not None:
            drawn = ([], [])
            for i in range(len(keys)):
                for k, shape in enumerate(shapes):
                    drawn[k].append(torch.tensor(np.asarray(uniforms(start + i, shape))))
            return tuple(torch.stack(d).to(self.device) for d in drawn)
        (r_reve, _), (r_floor, _) = shapes
        rows = max(r_reve, r_floor)
        if len(keys) == 1 and self.device.type == "cuda":
            u = self._frame_draw(keys[0], (rows, n))[None]
        else:
            u = prng.uniform_stack(keys, (rows, n), self.dtype, self.device)
        return u[:, :r_reve], u[:, :r_floor]

    def _frame_draw(self, key, shape: tuple[int, int]) -> torch.Tensor:
        """One frame's draw of ``key`` on the card: a CUDA graph captured
        for the shape on first use and replayed, since issued eagerly the
        draw's ~150 elementwise launches cost over a millisecond of host time
        a frame (chip_smoke.py phase 1b times both). The key's words go in
        through pinned memory, with no host sync; the output is the graph's
        own, overwritten by the next frame's draw."""
        g = self._draw_graphs.get(shape[1], shape)
        g.inputs[0].copy_(torch.tensor([key], dtype=torch.int64).pin_memory(), non_blocking=True)
        return g.replay()

    def _preprocess(self, cloud: RadarCloud, ang_vel: torch.Tensor, prev_floor: torch.Tensor, draws):
        c = self.cfg
        p = c.preprocess
        span = self.timers.span
        cl = filters.nan_filter(cloud)
        cl = filters.power_filter(cl, p.power_threshold)
        with span("preprocess.reve"):
            ego = reve.estimate_ego_velocity(cl, c.reve, draws[0])
        # dynamic objects = RANSAC outliers (preprocessing_nodelet.cpp:766-774)
        dynamic_mask = cl.mask & ~ego.inlier_mask & ego.success
        with span("preprocess.filters"):
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
        with span("preprocess.floor"):
            fl = floor.detect_floor(cl.xyz, cl.mask, c.floor, draws[1])
            # floor fallback chain (floor_detection_nodelet.cpp:100-130):
            # detected -> previous -> initial plane; under-floor removal clips
            # the odometry input against it (+tolerance margin)
            eff_floor = torch.where(fl.found, fl.coeffs, prev_floor)
            if p.enable_under_floor_removal:
                sd = cl.xyz @ eff_floor[:3] + eff_floor[3] + c.floor.floor_tolerance
                cl = cl.and_mask(sd > 0)
        prepared = apdgicp.prepare(cl.xyz, cl.mask, c.registration, device=self.device)
        return cl, ego, prepared, fl, dynamic_mask, eff_floor

    def _frame_step(self, cloud, ang_vel, stamp, imu_dts, imu_acc, imu_gyr, imu_mask, draws=None, key=None):
        """preprocess -> odometry -> backend for one frame; the first frame
        initializes the odometry and the backend instead of matching.
        ``draws``: the frame's RANSAC scores (REVE's, the floor's); when
        None, drawn here from ``key``, the frame's subkey (or the
        ``uniforms`` seam at this frame's index)."""
        c = self.cfg
        st = self.state
        with self.timers.span("engine.preprocess"):
            if draws is None:
                with self.timers.span("preprocess.draw"):
                    reve_u, floor_u = self._draw_sequence([key], cloud.capacity, self._uniforms_fn, st.frame_idx)
                draws = (reve_u[0], floor_u[0])
            cl, ego, prepared, fl, dynamic_mask, st.floor_prev = self._preprocess(
                cloud, ang_vel, st.floor_prev, draws
            )
        oout = None
        if st.odo is None:
            # first frame (scan_matching_odometry_nodelet.cpp:431-445)
            if c.odometry.enable_scan_to_map:
                st.odo = scan2map.init_state(prepared, stamp, c.odometry, dtype=self.dtype)
            else:
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
            step = scan2map.step if c.odometry.enable_scan_to_map else odometry.step
            with self.timers.span("engine.odometry"):
                st.odo, oout = step(
                    st.odo, prepared, ego.v, stamp, c.odometry, c.registration, **imu_kw,
                    graphs=self.reg_graphs,
                )
            odom_pose = oout.odom
        frame = slam.BackendFrame(
            stamp=stamp, odom_R=odom_pose[:3, :3], odom_p=odom_pose[:3, 3],
            xyz=cl.xyz, mask=cl.mask, ego_vel=ego.v, ego_vel_cov=ego.sigma**2,
            imu_dts=imu_dts, imu_acc=imu_acc, imu_gyr=imu_gyr, imu_mask=imu_mask,
            floor=fl.coeffs, floor_valid=fl.found,
        )
        with self.timers.span("engine.backend"):
            st.backend, bout = slam.backend_step(st.backend, frame, c.backend, c.imu, self.graphs)
        return cl, ego, fl, dynamic_mask, oout, odom_pose, bout

    def process_frame(self, cloud: RadarCloud, stamp: float, imu_dts, imu_acc, imu_gyr,
                      imu_mask, altitude=None, gps_utm=None, gps_cov=None) -> dict:
        """Feed one radar frame (+ the IMU batch since the last). ``altitude``
        is the barometer reading (the loop prefilter's gate, and the optional
        z prior); ``gps_utm`` an optional UTM fix [easting, northing, alt]
        paired to this frame, a translation prior on its keyframe. Returns
        the reference's output dict."""
        st = self.state
        with self.timers.frame(st.frame_idx):
            return self._process_frame(cloud, stamp, imu_dts, imu_acc, imu_gyr, imu_mask, altitude,
                                       gps_utm, gps_cov)

    def _process_frame(self, cloud, stamp, imu_dts, imu_acc, imu_gyr, imu_mask, altitude, gps_utm,
                       gps_cov) -> dict:
        c = self.cfg
        st = self.state
        span = self.timers.span
        # merge the async worker's finished detections first, so that this
        # frame's keyframe chains onto the corrected graph
        with span("engine.merge_loops"):
            loop_applied = self._apply_pending_loops()
        with self.timers.time("frame_step"):
            with span("engine.inputs"):
                self.key, k1 = prng.split(self.key)  # every frame, frame 0 included
                imu_acc, imu_gyr, ang_vel = _imu_in_radar_frame(c.imu, imu_acc, imu_gyr, imu_mask)
                if st.floor_prev is None:
                    # initial fallback plane (floor_detection_nodelet.cpp:122-127)
                    st.floor_prev = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=self.dtype, device=self.device)
                up = self._upload
                inputs = (up(ang_vel), up(stamp), up(imu_dts), up(imu_acc), up(imu_gyr),
                          up(imu_mask, torch.bool))
            cl, ego, fl, dynamic_mask, oout, odom_pose, bout = self._frame_step(cloud, *inputs, key=k1)
        with span("engine.outputs"):
            if oout is None:
                is_kf, reg_ok, status = True, True, None
            else:
                is_kf = bool(oout.is_keyframe)
                reg_ok = bool(oout.reg.converged)
                status = self._scan_matching_status(oout)
        loop_found = loop_applied
        if is_kf:
            with span("engine.keyframe", sample="loop"):
                loop_found = self._on_keyframe(cl, odom_pose, stamp, altitude, gps_utm, gps_cov) or loop_found
        st.frame_idx += 1
        with span("engine.outputs"):
            pose = bout.pose.cpu().numpy()
            st.trajectory.append((stamp, pose))
            return {
                "odom": odom_pose.cpu().numpy(),
                "pose": pose,
                "is_keyframe": is_kf,
                "ego_velocity": ego.v.cpu().numpy(),
                "floor": fl.coeffs.cpu().numpy() if bool(fl.found) else None,
                "chi2": float(bout.chi2),
                "loop_found": loop_found,
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

    # ---- whole-sequence replay ----------------------------------------------
    def replay_sequence(self, stacked: dict) -> dict:
        """Every frame of a stacked sequence (``io.datasets.stack_sequence``
        or ``stack_native_sequence``) through preprocess -> REVE -> floor ->
        odometry -> window backend: the reference's one-``lax.scan``
        replay, the sequential real-time-factor protocol. Loop closure and
        the keyframe graph are host stages and are not replayed (the
        reference's loop path is offline); ``process_frame`` runs them.

        The inputs are uploaded once, every frame's RANSAC scores are drawn
        before frame 0, in one call, from the F subkeys of the Engine key's
        ``split_chain`` (the reference's per-frame keys; the key advances as
        F ``process_frame`` calls advance it) or from the ``uniforms`` seam,
        called with the frame's index in the sequence; each frame's outputs
        go into [F, ...] device tensors, and those are copied to the host
        once, at the end. The frame step is ``process_frame``'s, with the
        Engine's CUDA graphs: a fresh Engine gives its loop-off
        ``process_frame`` trajectory bitwise. The frame step still reads the
        host once per outer iteration of the registration and of the window
        solve (and, with scan-to-map, once for the keyframe flag); the
        per-frame outputs are not read. The Engine's session state is left
        as it was.

        Returns numpy arrays: odom [F,4,4], pose [F,4,4] (the window
        backend's estimate), is_keyframe [F], converged [F], chi2 [F],
        ego_vel [F,3], solver_iterations [F].

        Spans: ``engine.replay`` around the call, and inside it
        ``replay.draws``, ``replay.upload``, ``replay.frame`` (each frame's
        step) and ``replay.read`` (the outputs to the host)."""
        span = self.timers.span
        with span("engine.replay"):
            n = np.asarray(stacked["xyz"]).shape[-2]
            self.key, keys = prng.split_chain(self.key, len(stacked["stamps"]))
            with span("replay.draws"):
                draws = self._draw_sequence(keys, n, self._uniforms_fn)
            with span("replay.upload"):
                inputs = self._prep_stacked(stacked)
            return self._replay(inputs, draws)

    def replay_fleet(self, stacked: dict, mesh=None, axis: str = "data") -> dict:
        """B independent sequences (every array of a ``stack_sequence`` dict
        with a leading [B]; equal F and capacities), each replayed as
        ``replay_sequence`` replays one; returns its dict with a leading
        [B]. The sequences run one after another on the Engine's stream.

        As in the reference, the call's ``base`` is the Engine's key, which
        then advances to ``split(key)[0]``, and sequence b draws its RANSAC
        scores from ``split_chain(fold_in(base, b), F)``: it replays as
        ``replay_sequence`` on an Engine whose key is ``fold_in(base, b)``.
        The ``uniforms`` seam is called as
        ``uniforms(frame_index, shape, sequence=b)``.

        With a ``mesh`` (``dist/mesh.py``; every rank calls with the whole
        batch) each rank of ``axis`` replays its contiguous slice of the B
        sequences, sequence b still keyed ``fold_in(base, b)`` for its
        global b and ``base`` taken from axis rank 0, and the outputs are
        gathered: every rank returns what the unmeshed call returns. B must
        divide by the axis size."""
        B, F = np.asarray(stacked["stamps"]).shape
        n = np.asarray(stacked["xyz"]).shape[-2]
        base = self.key
        self.key = prng.split(self.key)[0]
        mine = range(B)
        if mesh is not None:
            from rivslam_tpu_torch.dist import mesh as dmesh

            group = mesh.get_group(axis)
            rows = dmesh.all_gather_rows(torch.tensor([base], dtype=torch.int64, device=self.device), group)
            base = tuple(int(w) for w in rows[0])
            mine = dmesh.local_slice(torch.arange(B), mesh, axis).tolist()
        outs = []
        for b in mine:
            _, keys = prng.split_chain(prng.fold_in(base, b), F)
            seam = None if self._uniforms_fn is None else functools.partial(self._uniforms_fn, sequence=b)
            draws = self._draw_sequence(keys, n, seam)
            outs.append(self._replay(self._prep_stacked({k: v[b] for k, v in stacked.items()}), draws))
        out = {k: np.stack([o[k] for o in outs]) for k in outs[0]}
        if mesh is not None:
            out = {k: dmesh.all_gather_rows(torch.as_tensor(v, device=self.device), group).cpu().numpy()
                   for k, v in out.items()}
        return out

    def _prep_stacked(self, stacked: dict):
        """A stacked sequence's arrays on the device: the clouds, the
        per-frame angular velocity (the first valid gyro sample), stamps and
        IMU buffers, rotated into the radar frame with ``imu.apply_extrinsics``
        frame by frame in float64 before the cast, as ``process_frame``
        converts them."""
        imask = np.asarray(stacked["imu_mask"])
        frames = [_imu_in_radar_frame(self.cfg.imu, a, g, m)
                  for a, g, m in zip(np.asarray(stacked["imu_acc"]), np.asarray(stacked["imu_gyr"]), imask)]
        acc, gyr, ang_vel = (np.stack(x) for x in zip(*frames))
        up = self._upload
        clouds = RadarCloud(xyz=up(stacked["xyz"]), doppler=up(stacked["doppler"]),
                            intensity=up(stacked["intensity"]), mask=up(stacked["mask"], torch.bool))
        return clouds, up(ang_vel), up(stacked["stamps"]), (up(stacked["imu_dts"]), up(acc), up(gyr),
                                                            up(imask, torch.bool))

    def _replay(self, inputs, draws) -> dict:
        """The frame step over every frame of ``_prep_stacked``'s inputs on
        a fresh session state; outputs gathered on the device."""
        clouds, ang_vel, stamps, (dts, acc, gyr, imask) = inputs
        F, dt, dev = stamps.shape[0], self.dtype, self.device
        out = {
            "odom": torch.empty((F, 4, 4), dtype=dt, device=dev),
            "pose": torch.empty((F, 4, 4), dtype=dt, device=dev),
            "is_keyframe": torch.ones(F, dtype=torch.bool, device=dev),
            "converged": torch.ones(F, dtype=torch.bool, device=dev),
            "chi2": torch.empty(F, dtype=dt, device=dev),
            "ego_vel": torch.empty((F, 3), dtype=dt, device=dev),
        }
        iterations = np.zeros(F, np.int32)  # counted on the host by the window solve
        saved = self.state
        self.state = EngineState(floor_prev=torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dt, device=dev))
        span = self.timers.span
        try:
            for i in range(F):
                with span("replay.frame"):
                    cloud = RadarCloud(xyz=clouds.xyz[i], doppler=clouds.doppler[i],
                                       intensity=clouds.intensity[i], mask=clouds.mask[i])
                    _, ego, _, _, oout, odom_pose, bout = self._frame_step(
                        cloud, ang_vel[i], stamps[i], dts[i], acc[i], gyr[i], imask[i],
                        draws=(draws[0][i], draws[1][i]),
                    )
                    out["odom"][i] = odom_pose
                    out["pose"][i] = bout.pose
                    out["chi2"][i] = bout.chi2
                    out["ego_vel"][i] = ego.v
                    iterations[i] = bout.iterations
                    if oout is not None:  # frame 0 is a converged keyframe
                        out["is_keyframe"][i] = oout.is_keyframe
                        out["converged"][i] = oout.reg.converged
        finally:
            self.state = saved
        with span("replay.read"):
            res = {k: v.cpu().numpy() for k, v in out.items()}
        res["solver_iterations"] = iterations
        return res

    # ---- the keyframe graph ----------------------------------------------
    def _edge_info(self, xyz1, mask1, xyz2, mask2, relpose) -> torch.Tensor:
        """Fitness-based 6x6 information of a graph edge (K3 inside)."""
        return infomat.calc_information_matrix(
            xyz1, mask1, xyz2, mask2, relpose, self.cfg.backend, scaled=False
        )

    def _solve_graph(self, g: global_graph.PoseGraph, timer: str = "graph_opt") -> global_graph.PoseGraph:
        with self.timers.span("engine.global_solve", sample=timer):
            if self.cfg.loop.global_solver == "SCHUR":
                g, _ = block_schur.solve_pose_graph_schur(g, num_blocks=self.cfg.loop.schur_blocks)
            else:
                g, _ = global_graph.solve_pose_graph(g)
        return g

    def _has_priors_or_loops(self) -> bool:
        g = self.state.graph
        return g is not None and bool(g.loop_mask.any() | g.gps_mask.any())

    def _on_keyframe(self, cl: RadarCloud, odom_pose, stamp: float, altitude=None,
                     gps_utm=None, gps_cov=None) -> bool:
        """Keyframe hook: graph insertion (always on the frame's thread:
        later keyframes chain onto it), then, with loop.enable, loop
        detection on a snapshot of the state: inline, or handed to the
        worker with loop.async_loop."""
        c = self.cfg
        st = self.state
        with self.timers.span("keyframe.insert"):
            k = self._insert_keyframe(cl, odom_pose, stamp, altitude, gps_utm, gps_cov)
        if k is None or not c.loop.enable or st.kf_count < c.loop.num_exclude_recent + 2:
            return False
        # tensors are never written in place on the keyframe path (graph rows
        # go through _with_rows, which clones), and the lists are copied: the
        # worker sees the state as it is now
        snap = {
            "xyz": cl.xyz, "intensity": cl.intensity, "mask": cl.mask, "k": k,
            "odom_pose": odom_pose, "graph": st.graph, "scdb": st.scdb,
            "kf_clouds": list(st.kf_clouds), "kf_accum": list(st.kf_accum),
            "kf_alt": list(st.kf_alt), "kf_odom": list(st.kf_odom), "kf_count": st.kf_count,
            "last_loop_accum": st.last_loop_accum, "prev_loop": st.prev_loop,
            "epoch": st.compact_epoch,
        }
        if c.loop.async_loop:
            self._submit_loop_job(snap)
            return False
        with self.timers.span("engine.loop_detection"):
            det = self._run_loop_detection(snap)
        return det is not None and self._accept_loop(det)

    def _insert_keyframe(self, cl: RadarCloud, odom_pose, stamp: float, altitude=None,
                         gps_utm=None, gps_cov=None):
        """Global-graph node + odometry edge, scan-context insert, host-side
        lists, GPS/UTM or barometer prior. Returns the node index, or None
        when the graph is full and cannot compact."""
        c = self.cfg
        st = self.state
        dt, dev = self.dtype, self.device
        if st.scdb is None:
            st.scdb = scancontext.ScanContextDB.create(c.loop, dtype=dt, device=dev)
            st.graph = global_graph.PoseGraph.create(
                c.loop.keyframe_capacity, c.loop.loop_capacity, dtype=dt, device=dev
            )
        k = st.kf_count
        if k >= c.loop.keyframe_capacity:
            if c.loop.compact_on_full:
                self._compact_keyframes()
                k = st.kf_count
            if k >= c.loop.keyframe_capacity:
                return None

        # the edge measurement is the RAW odometry delta; the node's initial
        # estimate chains it onto the (possibly loop-corrected) previous node
        g = st.graph
        if k == 0:
            rel = torch.eye(4, dtype=dt, device=dev)
            est_T = odom_pose
            edge_info = torch.eye(6, dtype=dt, device=dev)
        else:
            rel = lie.se3_inverse(st.kf_odom[-1]) @ odom_pose
            est_T = lie.se3_matrix(g.R[k - 1], g.p[k - 1]) @ rel
            # fitness-based information, as the reference's odometry edges
            # (flush_keyframe_queue -> calc_information_matrix)
            prev_xyz, prev_mask = st.kf_clouds[-1]
            edge_info = self._edge_info(cl.xyz, cl.mask, prev_xyz, prev_mask, lie.se3_inverse(rel))
        st.kf_odom.append(odom_pose)
        st.graph = _with_rows(
            g, k, R=est_T[:3, :3], p=est_T[:3, 3], node_mask=True, odom_rel_R=rel[:3, :3],
            odom_rel_p=rel[:3, 3], odom_info=edge_info,
        )
        st.scdb, dropped = scancontext.insert(
            st.scdb, scancontext.make_descriptor(cl.xyz, cl.intensity, cl.mask, c.loop)
        )
        if dropped:
            self.loop_stats["sc_dropped_capacity"] += 1
        st.kf_clouds.append((cl.xyz, cl.mask))
        st.kf_stamps.append(stamp)
        odo = st.odo.base if isinstance(st.odo, scan2map.SubmapOdometryState) else st.odo
        st.kf_accum.append(float(odo.accum_distance))
        st.kf_alt.append(float("nan") if altitude is None else float(altitude))
        st.kf_count += 1

        # GPS/UTM translation prior (EdgeSE3PriorXYZ; keyframe.hpp:52); the
        # first accepted fix anchors the UTM origin (nodelet:1453 zero_utm)
        if c.gps.enable and gps_utm is not None:
            utm = np.asarray(gps_utm, np.float64).reshape(3)
            if st.zero_utm is None:
                st.zero_utm = utm.copy()
            if (c.gps.use_fix_covariance and gps_cov is not None
                    and bool(np.all(np.isfinite(np.asarray(gps_cov, np.float64))))):
                info3 = 1.0 / np.maximum(np.asarray(gps_cov, np.float64), 1e-6)
            else:
                info3 = 1.0 / np.asarray([c.gps.stddev_xy**2, c.gps.stddev_xy**2, c.gps.stddev_z**2])
            self._set_prior(k, utm - st.zero_utm, info3)
            st.gps_kf_since_solve += 1
            if c.gps.solve_interval > 0 and st.gps_kf_since_solve >= c.gps.solve_interval:
                st.graph = self._solve_graph(st.graph)
                st.gps_kf_since_solve = 0
        elif c.loop.baro_z_prior and altitude is not None and np.isfinite(altitude):
            # barometer altitude prior (EdgeSE3PriorZ): a z-only row of the
            # diagonal translation prior, relative to the first reading
            if st.baro_zero is None:
                st.baro_zero = float(altitude)
            z_rel = float(altitude) - st.baro_zero
            self._set_prior(k, [0.0, 0.0, z_rel], [0.0, 0.0, 1.0 / c.loop.baro_z_stddev**2])
        return k

    def _set_prior(self, k: int, xyz, info3) -> None:
        st = self.state
        up = self._upload
        st.graph = _with_rows(st.graph, k, gps_xyz=up(xyz), gps_info=up(info3), gps_mask=True)

    def _compact_keyframes(self) -> None:
        """Halve the graph when keyframe capacity fills: keep the anchor,
        every loop endpoint, the recent tail and every other node; compose
        the odometry edges across dropped nodes (global_graph.compact)."""
        st = self.state
        c = self.cfg
        n = st.kf_count
        if n < 4 or st.graph is None:
            return
        keep = set(range(0, n, 2)) | {0, n - 1}
        tail = min(c.loop.num_exclude_recent, max(1, n // 4))
        keep.update(range(max(0, n - tail), n))
        lmask = st.graph.loop_mask.cpu().numpy()
        li, lj = st.graph.loop_i.cpu().numpy(), st.graph.loop_j.cpu().numpy()
        for e in np.flatnonzero(lmask):
            keep.update((int(li[e]), int(lj[e])))
        keep = sorted(i for i in keep if i < n)
        if len(keep) >= n:
            return
        st.graph, _ = global_graph.compact(st.graph, keep, n)
        st.scdb = scancontext.compact(st.scdb, keep)
        for name in ("kf_clouds", "kf_stamps", "kf_accum", "kf_alt", "kf_odom"):
            setattr(st, name, [getattr(st, name)[i] for i in keep])
        st.kf_count = len(keep)
        # the pairwise-consistency memory holds old indices, and so do the
        # async worker's detections in flight: the epoch drops their results
        st.prev_loop = None
        st.compact_epoch += 1

    # ---- loop detection ----------------------------------------------------
    def _run_loop_detection(self, snap: dict):
        """Scan-context match + registration verify + consistency gates for
        keyframe snap["k"] over a snapshot of the state (``_on_keyframe``);
        safe on the worker thread. Returns the accepted-loop record, or
        None."""
        c = self.cfg
        K = c.loop.keyframe_capacity
        k, n = snap["k"], snap["kf_count"]
        kf_clouds = snap["kf_clouds"]
        stats = self.loop_stats
        stats["detections_run"] += 1

        def padded(values, fill=0.0):
            a = np.full(K, fill, np.float64)
            a[:n] = values
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        alt = np.asarray(snap["kf_alt"], np.float64)
        alt_valid = np.zeros(K, bool)
        alt_valid[:n] = ~np.isnan(alt)
        g = snap["graph"]
        cand = detector.prefilter_candidates(
            padded(snap["kf_accum"]), g.R, g.p, g.node_mask, k, snap["last_loop_accum"], c.loop,
            altitude=padded(np.nan_to_num(alt)),
            altitude_valid=torch.as_tensor(alt_valid, device=self.device),
        )
        xyz, mask = snap["xyz"], snap["mask"]
        desc = scancontext.make_descriptor(xyz, snap["intensity"], mask, c.loop)
        if c.loop.verify_candidates > 1:
            # verify the top-k scan-context candidates as one batch, keep the
            # best-fitness pass
            idxs, yaws, _, valid = scancontext.match_topk(
                snap["scdb"], desc, k, cand, c.loop, c.loop.verify_candidates
            )
            idxs_h = idxs.cpu().numpy()
            if not (idxs_h >= 0).any():
                stats["no_candidate"] += 1
                return None
            gather = [max(int(i), 0) for i in idxs_h]
            res, oks, best = detector.verify_loops_batch(
                xyz, mask, torch.stack([kf_clouds[i][0] for i in gather]),
                torch.stack([kf_clouds[i][1] for i in gather]), yaws, valid,
                c.registration, c.loop,
            )
            if not bool(oks.any()):
                stats["rejected_verify"] += 1
                return None
            b = int(best)
            idx = int(idxs_h[b])
            T_lc = res.T[b]
        else:
            idx_t, yaw, _ = scancontext.match(snap["scdb"], desc, k, cand, c.loop)
            idx = int(idx_t)
            if idx < 0:
                stats["no_candidate"] += 1
                return None
            cand_xyz, cand_mask = kf_clouds[idx]
            res, ok = detector.verify_loop(
                xyz, mask, cand_xyz, cand_mask, c.registration, c.loop, yaw_guess=yaw
            )
            if not bool(ok):
                stats["rejected_verify"] += 1
                return None
            T_lc = res.T
        # odometry check: T_lc maps the new cloud into the candidate's frame;
        # both poses are RAW odometry (loop_detector.cpp:252,278-283)
        odom_i, odom_j = snap["kf_odom"][idx], snap["odom_pose"]
        T_jl = lie.se3_inverse(T_lc)
        if not bool(detector.odometry_check(T_jl, odom_i, odom_j, k - idx, c.loop)):
            stats["rejected_odom_check"] += 1
            return None
        prev = snap["prev_loop"]
        if prev is not None:
            stats["pairwise_checked"] += 1
            if not bool(detector.pairwise_check(
                T_jl, odom_i, odom_j, prev["odom_i"], prev["odom_j"], prev["T_lc"], True, c.loop
            )):
                stats["rejected_pairwise"] += 1
                return None
        # information from the registration fitness between the matched
        # clouds (loop_detector.cpp:314); measurement T_i^-1 T_j = T_lc
        cand_xyz, cand_mask = kf_clouds[idx]
        loop_info = self._edge_info(xyz, mask, cand_xyz, cand_mask, T_jl)
        return {"k": k, "idx": idx, "T_lc": T_lc, "loop_info": loop_info,
                "odom_i": odom_i, "odom_j": odom_j, "accum": float(snap["kf_accum"][k]),
                "epoch": snap["epoch"]}

    def _add_loop_edge(self, g: global_graph.PoseGraph, det: dict):
        """g with det's loop edge in the next free slot; None when full."""
        ln = int(g.loop_mask.sum())
        if ln >= g.loop_i.shape[0]:
            return None
        T_lc = det["T_lc"]
        return _with_rows(
            g, ln, loop_i=det["idx"], loop_j=det["k"], loop_rel_R=T_lc[:3, :3],
            loop_rel_p=T_lc[:3, 3], loop_info=det["loop_info"], loop_mask=True,
        )

    def _accept_loop(self, det: dict, solved=None) -> bool:
        """Commit an accepted loop to the live graph: add the edge, update
        the gating memory, then re-optimize (``solved`` None: the
        synchronous path) or merge the worker's solved poses (R, p)."""
        st = self.state
        g2 = self._add_loop_edge(st.graph, det)
        if g2 is None:
            self.loop_stats["dropped_capacity"] += 1
            return False
        self.loop_stats["accepted"] += 1
        st.last_loop_accum = det["accum"]
        st.prev_loop = {"odom_i": det["odom_i"], "odom_j": det["odom_j"], "T_lc": det["T_lc"]}
        if solved is None:
            st.graph = self._solve_graph(g2)
        else:
            R, p = _merge_chain(g2.R, g2.p, solved[0], solved[1], g2.odom_rel_R, g2.odom_rel_p,
                                det["k"], st.kf_count)
            st.graph = dataclasses.replace(g2, R=R, p=p)
        st.gps_kf_since_solve = 0
        return True

    # ---- the asynchronous loop worker ----------------------------------------
    def _submit_loop_job(self, snap: dict) -> None:
        """Queue a detection job; at most one in flight. While the worker is
        busy the keyframe goes undetected, as a reference timer tick that
        arrives before the previous one finished."""
        if self._loop_busy:
            self._loop_skipped += 1
            self.loop_stats["skipped_worker_busy"] += 1
            return
        if self._loop_thread is None:
            if self.device.type == "cuda":
                self._loop_stream = torch.cuda.Stream(self.device)
            self._loop_queue = queue.Queue()
            self._loop_thread = threading.Thread(target=self._loop_worker, name="loop-closure",
                                                 daemon=True)
            self._loop_thread.start()
        if self._loop_stream is not None:
            # the worker's stream starts after the work that made the snapshot
            snap["ready"] = torch.cuda.Event()
            snap["ready"].record(torch.cuda.current_stream(self.device))
        self._loop_busy = True
        self._loop_queue.put(snap)

    def _loop_job(self, snap: dict):
        """One job on the worker thread: detection, then on acceptance the
        loop edge and the global solve on the snapshot's graph. Returns
        (det, solved (R, p) or None)."""
        with self.timers.span("engine.loop_detection", sample="loop_detect_async"):
            det = self._run_loop_detection(snap)
        if det is None:
            return None, None
        g2 = self._add_loop_edge(snap["graph"], det)
        if g2 is None:
            return None, None
        gs = self._solve_graph(g2, timer="graph_opt_async")
        return det, (gs.R, gs.p)

    def _loop_worker(self) -> None:
        """The worker thread: runs jobs until it is handed None. Inputs are
        the snapshot's tensors (never written in place) and copied lists;
        results go back to the frame's thread, which merges them."""
        stream = self._loop_stream
        with cuda_build.counting_as_worker(), (
                torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()):
            while True:
                snap = self._loop_queue.get()
                if snap is None:
                    return
                det, solved, done = None, None, None
                try:
                    with cuda_graph.LOCK:
                        if stream is not None:
                            stream.wait_event(snap["ready"])
                            for t in _tensors(snap):
                                if t.is_cuda:
                                    t.record_stream(stream)
                        det, solved = self._loop_job(snap)
                        if stream is not None:
                            done = torch.cuda.Event()
                            done.record(stream)
                except BaseException as e:  # raised on the frame's thread
                    self._loop_error = e
                    det, solved = None, None
                with self._loop_lock:
                    self._loop_results.append({"det": det, "solved": solved, "done": done})

    def _apply_pending_loops(self) -> bool:
        """Merge the worker's finished detections on the frame's thread,
        then capture the verification graphs the worker left; a no-op
        without a worker. Raises a worker exception here."""
        if self._loop_thread is None:
            return False
        if self._loop_error is not None:
            err, self._loop_error = self._loop_error, None
            raise err
        with self._loop_lock:
            results, self._loop_results = self._loop_results, []
        applied = False
        for r in results:
            self._loop_busy = False
            det = r["det"]
            if r["done"] is not None:
                main = torch.cuda.current_stream(self.device)
                main.wait_event(r["done"])
                for t in _tensors((det, r["solved"])):
                    if t.is_cuda:
                        t.record_stream(main)
            if det is not None and det["epoch"] == self.state.compact_epoch:
                applied = self._accept_loop(det, solved=r["solved"]) or applied
        if results and self.device.type == "cuda":
            # the verification graphs the worker left to this thread (it
            # captures none itself); the worker is idle until the next job
            apdgicp.capture_deferred()
        return applied

    def drain_loops(self, poll_s: float = 0.002) -> bool:
        """Block until the worker is idle and every finished detection is
        merged; True if a loop was applied. Draining after every frame gives
        the synchronous path bitwise."""
        applied = False
        while True:
            applied = self._apply_pending_loops() or applied
            if not self._loop_busy:
                return applied
            time.sleep(poll_s)

    def close(self) -> None:
        """Stop the worker thread (a daemon: optional). Finished results stay
        mergeable through ``drain_loops``."""
        if self._loop_thread is not None:
            self._loop_queue.put(None)
            self._loop_thread.join(timeout=10.0)
            self._loop_thread = None

    # ------------------------------------------------------------------------
    def finalize(self) -> None:
        """Drain the worker, then re-optimize the global graph over the final
        keyframe set; a no-op when it has no loop edge and no GPS/barometer
        prior."""
        self.drain_loops()
        if self._has_priors_or_loops():
            self.state.graph = self._solve_graph(self.state.graph)

    def predict_highrate(self, imu_dts, imu_acc, imu_gyr, imu_mask):
        """IMU-rate pose prediction from the last optimized state: the
        reference's imu_callback -> preinteg_predict -> ``imuPre/odometry``
        publisher (radar_graph_slam_nodelet.cpp:589-633). A 4x4 pose, or None
        before the first frame."""
        from rivslam_tpu_torch.core.navstate import NavState
        from rivslam_tpu_torch.factors import preintegration as pre

        st = self.state
        if st.backend is None:
            return None
        nav = st.backend.nav
        up = self._upload
        p_int = pre.preintegrate(up(imu_dts), up(imu_acc), up(imu_gyr), up(imu_mask, torch.bool),
                                 nav.bg[-1], nav.ba[-1], self.cfg.imu.gyr_noise, self.cfg.imu.acc_noise)
        out = pre.predict(NavState(t=st.backend.stamps[-1], R=nav.R[-1], p=nav.p[-1], v=nav.v[-1],
                                   bg=nav.bg[-1], ba=nav.ba[-1]), p_int, self.cfg.imu.gravity)
        return lie.se3_matrix(out.R, out.p).cpu().numpy()

    def optimized_keyframe_poses(self) -> np.ndarray:
        """[K_used, 4, 4] globally optimized keyframe poses."""
        st = self.state
        if st.graph is None or st.kf_count == 0:
            return np.zeros((0, 4, 4))
        out = np.tile(np.eye(4), (st.kf_count, 1, 1))
        out[:, :3, :3] = st.graph.R[: st.kf_count].cpu().numpy()
        out[:, :3, 3] = st.graph.p[: st.kf_count].cpu().numpy()
        return out

    def trajectory(self, corrected: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """Per-frame trajectory (stamps [F], poses [F,4,4]). With
        ``corrected=True`` (the default) the graph's correction reaches
        every frame: the odom->map delta is interpolated between the
        bracketing keyframes (the reference's trans_odom2map role, extended
        to a per-frame retarget). Without loop edges or priors, or with
        ``corrected=False``, the window backend's poses come back as they
        are."""
        st = self.state
        ts = np.asarray([s for s, _ in st.trajectory])
        poses = np.stack([T for _, T in st.trajectory]) if ts.size else np.zeros((0, 4, 4))
        if not corrected or st.kf_count == 0 or not self._has_priors_or_loops():
            return ts, poses
        G = self.optimized_keyframe_poses()  # [K,4,4] map frame
        O = np.stack([T.cpu().numpy().astype(np.float64) for T in st.kf_odom])  # odom frame
        C = np.einsum("kij,kjl->kil", G, np.linalg.inv(O))  # per-keyframe odom->map
        kf_ts = np.asarray(st.kf_stamps, np.float64)
        out = np.empty_like(poses)
        seg = np.clip(np.searchsorted(kf_ts, ts, side="right") - 1, 0, len(kf_ts) - 1)
        xis = [_se3_log_np(np.linalg.inv(C[k]) @ C[k + 1]) for k in range(len(kf_ts) - 1)]
        for f in range(len(ts)):
            k = int(seg[f])
            if k >= len(kf_ts) - 1:
                corr = C[-1]
            else:
                span = kf_ts[k + 1] - kf_ts[k]
                s = 0.0 if span <= 0 else float(np.clip((ts[f] - kf_ts[k]) / span, 0.0, 1.0))
                corr = C[k] @ _se3_exp_np(s * xis[k])
            out[f] = corr @ poses[f]
        return ts, out
