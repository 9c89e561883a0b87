"""The benchmark's traffic generator: radar-realistic synthetic courses.

A frozen copy of ``rivslam_tpu_torch/io/synthetic.py`` (``make_world``,
``circular_trajectory``, ``circular_imu_samples``, ``simulate_sequence``)
and of the per-frame slicing of ``rivslam_tpu_torch/io/datasets.py``
(``RadarSequence.frame``, ``imu_between``, ``baro_at``, the padding of
``RadarCloud.from_numpy``), numpy only. The same seed gives the same arrays
as the port's generator did when it was copied
(``benchmark/tests/test_bench_traffic.py``); later changes to the port's
generator do not move what the benchmark measures.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Course:
    """A simulated course: ragged radar frames, the IMU stream, ground truth
    and the barometer stream."""

    frames: list  # per frame: dict(stamp, xyz [n, 3], doppler [n], intensity [n])
    imu_stamps: np.ndarray  # [M]
    imu_acc: np.ndarray  # [M, 3]
    imu_gyr: np.ndarray  # [M, 3]
    gt_stamps: np.ndarray  # [F]
    gt_poses: np.ndarray  # [F, 4, 4] world_T_sensor
    baro_stamps: np.ndarray | None = None
    baro_alt: np.ndarray | None = None

    @property
    def num_frames(self) -> int:
        return len(self.frames)

    def padded(self, i: int, capacity: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Frame i padded or cut to ``capacity``: (xyz [C, 3], doppler [C],
        intensity [C], mask [C]) in float64, as ``RadarCloud.from_numpy``
        pads a scan."""
        f = self.frames[i]
        n = min(len(f["xyz"]), capacity)
        xyz = np.zeros((capacity, 3))
        dop = np.zeros(capacity)
        inten = np.zeros(capacity)
        mask = np.zeros(capacity, bool)
        xyz[:n], dop[:n], inten[:n], mask[:n] = f["xyz"][:n], f["doppler"][:n], f["intensity"][:n], True
        return xyz, dop, inten, mask

    def imu_between(self, t0: float, t1: float, capacity: int):
        """Masked fixed-capacity IMU batch in (t0, t1], with per-sample dt
        clamped to [1e-4, 0.05] s."""
        sel = (self.imu_stamps > t0) & (self.imu_stamps <= t1)
        idx = np.where(sel)[0][:capacity]
        k = len(idx)
        dts = np.zeros(capacity)
        acc = np.zeros((capacity, 3))
        gyr = np.zeros((capacity, 3))
        m = np.zeros(capacity, dtype=bool)
        if k:
            d = np.diff(np.concatenate([[t0], self.imu_stamps[idx]]))
            dts[:k] = np.clip(d, 1e-4, 0.05)
            acc[:k] = self.imu_acc[idx]
            gyr[:k] = self.imu_gyr[idx]
            m[:k] = True
        return dts, acc, gyr, m

    def imu_for_frame(self, i: int, capacity: int):
        """The IMU batch handed over with frame i: the samples since the
        previous frame (frame 0: the last 0.1 s)."""
        t1 = self.frames[i]["stamp"]
        t0 = self.frames[i - 1]["stamp"] if i > 0 else t1 - 0.1
        return self.imu_between(t0, t1, capacity)

    def baro_at(self, t: float, max_gap: float = 1.0) -> float | None:
        """Nearest barometer altitude within ``max_gap`` seconds of t."""
        if self.baro_stamps is None or len(self.baro_stamps) == 0:
            return None
        i = int(np.argmin(np.abs(self.baro_stamps - t)))
        if abs(float(self.baro_stamps[i]) - t) > max_gap:
            return None
        return float(self.baro_alt[i])


def make_world(rng: np.random.Generator, n_points: int = 4000, extent: float = 40.0):
    """A structured world: ground plane, a few walls, and volumetric scatter."""
    n_ground = n_points // 3
    n_wall = n_points // 3
    n_scatter = n_points - n_ground - n_wall
    ground = np.stack(
        [
            rng.uniform(-extent, extent, n_ground),
            rng.uniform(-extent, extent, n_ground),
            np.zeros(n_ground),
        ],
        axis=1,
    )
    walls = []
    for _ in range(4):
        c = rng.uniform(-extent, extent, 2)
        yaw = rng.uniform(0, np.pi)
        length = rng.uniform(8, 25)
        u = rng.uniform(-length / 2, length / 2, n_wall // 4)
        z = rng.uniform(0, 4.0, n_wall // 4)
        x = c[0] + np.cos(yaw) * u
        y = c[1] + np.sin(yaw) * u
        walls.append(np.stack([x, y, z], axis=1))
    walls = np.concatenate(walls)
    scatter = np.stack(
        [
            rng.uniform(-extent, extent, n_scatter),
            rng.uniform(-extent, extent, n_scatter),
            rng.uniform(0, 5.0, n_scatter),
        ],
        axis=1,
    )
    return np.concatenate([ground, walls, scatter])


def _strength(w: np.ndarray) -> np.ndarray:
    """Deterministic per-world-point reflectivity (radar RCS stand-in)."""
    return 10.0 + 20.0 * (
        0.5 + 0.5 * np.sin(w[:, 0] * 12.9898 + w[:, 1] * 78.233 + w[:, 2] * 37.719)
    )


def _rz(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def circular_trajectory(
    n_frames: int,
    radius: float = 15.0,
    height: float = 2.0,
    dt: float = 0.1,
    omega: float = 0.2,
):
    """Constant-speed circle with heading tangent to it.
    Returns (times [F], poses [F,4,4] world_T_sensor, velocities [F,3] world)."""
    times = np.arange(n_frames) * dt
    poses = np.zeros((n_frames, 4, 4))
    vels = np.zeros((n_frames, 3))
    for i, tt in enumerate(times):
        a = omega * tt
        poses[i, :3, :3] = _rz(a + np.pi / 2)
        poses[i, :3, 3] = [radius * np.cos(a), radius * np.sin(a), height]
        poses[i, 3, 3] = 1.0
        vels[i] = [-radius * omega * np.sin(a), radius * omega * np.cos(a), 0.0]
    return times, poses, vels


def circular_imu_samples(
    t0: float,
    t1: float,
    rate: float = 200.0,
    radius: float = 15.0,
    omega: float = 0.2,
    gravity: float = 9.80511,
    rng: np.random.Generator | None = None,
    gyro_noise: float = 0.0,
    acc_noise: float = 0.0,
):
    """Analytic IMU samples along the circular trajectory between two frame
    times. Returns (dts [K], acc [K,3] specific force, gyr [K,3])."""
    n = max(int(round((t1 - t0) * rate)), 1)
    ts = t0 + (np.arange(n) + 1) / rate
    dts = np.full(n, 1.0 / rate)
    G = np.array([0.0, 0.0, gravity])
    accs = np.zeros((n, 3))
    gyrs = np.tile(np.array([0.0, 0.0, omega]), (n, 1))
    for i, tt in enumerate(ts):
        a = omega * tt
        a_w = np.array(
            [-radius * omega**2 * np.cos(a), -radius * omega**2 * np.sin(a), 0.0]
        )
        yaw = a + np.pi / 2
        R = _rz(yaw)
        accs[i] = R.T @ (a_w + G)
    if rng is not None:
        accs += rng.normal(size=accs.shape) * acc_noise
        gyrs += rng.normal(size=gyrs.shape) * gyro_noise
    return dts, accs, gyrs


def simulate_sequence(
    seed: int = 0,
    n_frames: int = 180,
    radius: float = 10.0,
    omega: float = 0.3,
    dt: float = 0.25,
    height: float = 2.0,
    capacity: int = 1024,
    max_range: float = 60.0,
    fov_deg: float = 56.5,
    range_noise_rel: float = 0.86 / 400.0,
    az_noise_deg: float = 0.35,
    el_noise_deg: float = 0.35,
    az_bias_deg: float = 0.85,
    el_bias_deg: float = 0.85,
    cartesian_noise: float = 0.0,
    doppler_noise: float = 0.05,
    imu_rate: float = 100.0,
    gyro_noise: float = 0.002,
    acc_noise: float = 0.02,
    gyro_bias0: float = 0.002,
    acc_bias0: float = 0.05,
    gyro_bias_walk: float = 1e-5,
    acc_bias_walk: float = 1e-4,
    n_dynamic: int = 0,
    dynamic_speed: float = 2.0,
    world_points: int = 20000,
    extent: float = 40.0,
    baro: bool = True,
    baro_noise: float = 0.1,
    gravity: float = 9.80511,
    world_seed: int | None = None,
):
    """Radar-realistic synthetic dataset with ground truth, standing in for
    recorded NTU4DRadLM / MineAndForest sequences.

    Models the measurement chain the reference's sensors produce:
    - limited forward FoV (Oculii Eagle ~ +-56.5 deg azimuth — the scan
      context's LIDAR_FOV, Scancontext.h:110);
    - spherical measurement noise matched to the APDGICP adaptive covariance
      generative model (range sigma = range_noise_rel*r, az/el sigma in deg;
      fast_apdgicp_impl.hpp:166-184), DECOMPOSED into a persistent
      per-scatterer angular bias (az/el_bias_deg: array calibration,
      multipath geometry, off-grid beam quantization — systematic while the
      scene geometry persists, so it warps the map without driving
      frame-to-frame registration error) plus per-frame thermal jitter
      (az/el_noise_deg). Defaults give marginal sigma
      sqrt(0.85^2+0.35^2) ~ 0.92 deg ~ the launch-file az/el var of 1.0
      (launch:35-36); a pure-i.i.d. model at the full 1 deg makes every
      frame pair ~0.25 m inconsistent at 30 m range — harder than the
      real datasets the reference tracks;
    - per-target doppler from ego motion (+ moving targets) with noise —
      feeds REVE and dynamic-object removal;
    - intensity as a persistent world property (scan-context input);
    - IMU with white noise AND bias random walk (the backend's bias factors
      exist to track exactly this);
    - barometer altitude stream (loop prefilter baro gate input);
    - optional dynamic objects: point clusters on constant-velocity paths,
      with physically consistent doppler (REVE RANSAC should reject them).

    ``world_seed``, where given, draws the scene (the world, its
    per-scatterer biases and the dynamic objects) from a generator of its
    own, so that one deployment's scene stays fixed while ``seed`` draws
    the measurement noise, the IMU and the barometer; without it the scene
    comes from ``seed`` as in the port's generator.

    Returns the ``Course``.
    """
    rng = np.random.default_rng(seed)
    scene = rng if world_seed is None else np.random.default_rng(world_seed)
    world = make_world(scene, n_points=world_points, extent=extent)
    times, poses, vels = circular_trajectory(
        n_frames, radius=radius, height=height, dt=dt, omega=omega
    )

    # persistent per-scatterer measurement biases (see docstring)
    n_world = len(world)
    w_az_bias = scene.normal(size=n_world) * np.radians(az_bias_deg)
    w_el_bias = scene.normal(size=n_world) * np.radians(el_bias_deg)

    # dynamic objects: rigid clusters of ~24 points on straight paths
    dyn_centers = scene.uniform(-extent * 0.6, extent * 0.6, size=(n_dynamic, 3))
    if n_dynamic:
        dyn_centers[:, 2] = scene.uniform(0.5, 2.0, n_dynamic)
    dyn_dirs = scene.normal(size=(n_dynamic, 3))
    if n_dynamic:
        dyn_dirs[:, 2] = 0.0
        dyn_dirs /= np.maximum(np.linalg.norm(dyn_dirs, axis=1, keepdims=True), 1e-9)
    dyn_vels = dyn_dirs * dynamic_speed
    dyn_template = scene.normal(size=(n_dynamic, 24, 3)) * np.array([1.5, 0.8, 0.6])
    d_az_bias = scene.normal(size=n_dynamic * 24) * np.radians(az_bias_deg)
    d_el_bias = scene.normal(size=n_dynamic * 24) * np.radians(el_bias_deg)

    frames = []
    half_fov = np.radians(fov_deg)
    for i in range(n_frames):
        R, t = poses[i][:3, :3], poses[i][:3, 3]
        v_local = R.T @ vels[i]

        # --- static world observation -------------------------------------
        local = (world - t) @ R
        r = np.linalg.norm(local, axis=1)
        vis = (r > 1.0) & (r < max_range)
        az_all = np.arctan2(local[:, 1], local[:, 0])
        vis &= np.abs(az_all) < half_fov
        idx = np.where(vis)[0]
        strength = _strength(world[idx])
        # radar-equation range falloff: received SNR drops ~40 log10(r), so
        # detections concentrate close-range (the reference ships a
        # per-distance histogram diagnostic because this density profile is
        # what capacity/filter knobs are tuned against,
        # preprocessing_nodelet.cpp:818-828)
        det = strength - 25.0 * np.log10(np.maximum(r[idx], 1.0)) \
            + rng.normal(size=len(idx)) * 1.0
        if len(idx) > capacity:
            keep = np.argsort(-det)[:capacity]
            idx, strength = idx[keep], strength[keep]
        pts = local[idx]
        vel_pts = np.zeros_like(pts)  # static targets
        bias_az = w_az_bias[idx]
        bias_el = w_el_bias[idx]

        # --- dynamic targets ----------------------------------------------
        if n_dynamic:
            dyn_pts_w = (dyn_centers + dyn_vels * times[i])[:, None, :] + dyn_template
            dyn_v_w = np.repeat(dyn_vels, dyn_template.shape[1], axis=0)
            dyn_pts_w = dyn_pts_w.reshape(-1, 3)
            dloc = (dyn_pts_w - t) @ R
            dr = np.linalg.norm(dloc, axis=1)
            daz = np.arctan2(dloc[:, 1], dloc[:, 0])
            dvis = (dr > 1.0) & (dr < max_range) & (np.abs(daz) < half_fov)
            pts = np.concatenate([pts, dloc[dvis]])
            vel_pts = np.concatenate([vel_pts, (dyn_v_w[dvis]) @ R])
            strength = np.concatenate(
                [strength, 18.0 + rng.normal(size=int(dvis.sum())) * 2.0]
            )
            bias_az = np.concatenate([bias_az, d_az_bias[dvis]])
            bias_el = np.concatenate([bias_el, d_el_bias[dvis]])

        # --- spherical measurement noise ----------------------------------
        rr = np.linalg.norm(pts, axis=1)
        az = np.arctan2(pts[:, 1], pts[:, 0])
        el = np.arctan2(np.hypot(pts[:, 0], pts[:, 1]), pts[:, 2])
        dirs = pts / np.maximum(rr[:, None], 1e-9)
        # doppler BEFORE noise (true geometry), convention matches observe():
        # positive toward static targets when moving toward them
        dop = dirs @ v_local - np.sum(dirs * vel_pts, axis=1)
        dop += rng.normal(size=len(pts)) * doppler_noise
        if (range_noise_rel > 0 or az_noise_deg > 0 or el_noise_deg > 0
                or az_bias_deg > 0 or el_bias_deg > 0):
            rr = rr * (1.0 + rng.normal(size=len(pts)) * range_noise_rel)
            az = az + bias_az + rng.normal(size=len(pts)) * np.radians(az_noise_deg)
            el = el + bias_el + rng.normal(size=len(pts)) * np.radians(el_noise_deg)
            pts = np.stack(
                [rr * np.sin(el) * np.cos(az), rr * np.sin(el) * np.sin(az), rr * np.cos(el)],
                axis=1,
            )
        if cartesian_noise > 0:
            pts = pts + rng.normal(size=pts.shape) * cartesian_noise
        intensity = strength + rng.normal(size=len(pts)) * 0.5
        frames.append(
            dict(stamp=float(times[i]), xyz=pts, doppler=dop, intensity=intensity)
        )

    # --- IMU stream with noise + bias walk --------------------------------
    imu_t, imu_a, imu_g = [], [], []
    bg = rng.normal(size=3) * gyro_bias0
    ba = rng.normal(size=3) * acc_bias0
    for i in range(1, n_frames):
        d, a, g = circular_imu_samples(
            times[i - 1], times[i], rate=imu_rate, radius=radius, omega=omega,
            gravity=gravity,
        )
        ts = times[i - 1] + np.cumsum(d)
        for k in range(len(d)):
            bg = bg + rng.normal(size=3) * gyro_bias_walk * np.sqrt(d[k])
            ba = ba + rng.normal(size=3) * acc_bias_walk * np.sqrt(d[k])
            imu_t.append(ts[k])
            imu_a.append(a[k] + ba + rng.normal(size=3) * acc_noise)
            imu_g.append(g[k] + bg + rng.normal(size=3) * gyro_noise)

    course = Course(frames, np.asarray(imu_t), np.asarray(imu_a), np.asarray(imu_g),
                    gt_stamps=times.copy(), gt_poses=poses.copy())
    if baro:
        bt = np.arange(times[0], times[-1], 0.1)
        course.baro_stamps = bt
        course.baro_alt = np.full_like(bt, height) + rng.normal(size=len(bt)) * baro_noise
    return course
