"""Synthetic radar world and sequence generator (numpy-only port of
``rivslam_tpu/io/synthetic.py``).

``make_world``, ``observe`` and ``simulate_sequence`` (radar frames,
dynamic objects, IMU with bias walk, barometer) draw exactly the
reference's random numbers in the reference's order, so the same seed gives
the same arrays (the tests hold them equal).
``load_pairs`` is the counterpart of ``bench.py``'s protocol: B consecutive
frame pairs of one simulated course, padded to a capacity, with the ground
truth relative transform of each pair.
"""

from __future__ import annotations

import numpy as np
import torch

from rivslam_tpu_torch.core.device import resolve
from rivslam_tpu_torch.core.pointcloud import RadarCloud
from rivslam_tpu_torch.io.datasets import RadarSequence


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


def observe(
    world: np.ndarray,
    T_world_sensor: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 60.0,
    capacity: int = 1024,
    noise: float = 0.02,
    sensor_vel_world: np.ndarray | None = None,
    doppler_noise: float = 0.02,
    fov_deg: float | None = None,
    dtype=torch.float32,
    range_noise_rel: float = 0.0,
    az_noise_deg: float = 0.0,
    el_noise_deg: float = 0.0,
    device="cuda",
) -> RadarCloud:
    """Observe the world from a sensor pose: range-gate, optional forward
    field of view, noise (isotropic Cartesian and/or spherical radar noise),
    doppler from the sensor velocity (static world)."""
    R = T_world_sensor[:3, :3]
    t = T_world_sensor[:3, 3]
    local = (world - t) @ R  # R^T (p - t)
    r = np.linalg.norm(local, axis=1)
    vis = (r > 1.0) & (r < max_range)
    if fov_deg is not None:
        az = np.arctan2(local[:, 1], local[:, 0])
        vis &= np.abs(az) < np.radians(fov_deg)
    idx = np.where(vis)[0]
    if len(idx) > capacity:
        strength = _strength(world[idx]) + rng.normal(size=len(idx)) * 1.0
        idx = idx[np.argsort(-strength)[:capacity]]
    pts = local[idx]
    if range_noise_rel > 0.0 or az_noise_deg > 0.0 or el_noise_deg > 0.0:
        rr = np.linalg.norm(pts, axis=1)
        az = np.arctan2(pts[:, 1], pts[:, 0])
        el = np.arctan2(np.hypot(pts[:, 0], pts[:, 1]), pts[:, 2])
        rr = rr * (1.0 + rng.normal(size=len(idx)) * range_noise_rel)
        az = az + rng.normal(size=len(idx)) * np.radians(az_noise_deg)
        el = el + rng.normal(size=len(idx)) * np.radians(el_noise_deg)
        pts = np.stack(
            [
                rr * np.sin(el) * np.cos(az),
                rr * np.sin(el) * np.sin(az),
                rr * np.cos(el),
            ],
            axis=1,
        )
    if noise > 0.0:
        pts = pts + rng.normal(size=(len(idx), 3)) * noise
    if sensor_vel_world is not None:
        v_sensor = R.T @ sensor_vel_world
        dirs = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
        dop = dirs @ v_sensor + rng.normal(size=len(idx)) * doppler_noise
    else:
        dop = np.zeros(len(idx))
    intensity = _strength(world[idx]) + rng.normal(size=len(idx)) * 0.5
    return RadarCloud.from_numpy(
        pts, capacity, doppler=dop, intensity=intensity, dtype=dtype, device=device
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

    Returns (RadarSequence with ground truth, world points array).
    """
    rng = np.random.default_rng(seed)
    world = make_world(rng, n_points=world_points, extent=extent)
    times, poses, vels = circular_trajectory(
        n_frames, radius=radius, height=height, dt=dt, omega=omega
    )

    # persistent per-scatterer measurement biases (see docstring)
    n_world = len(world)
    w_az_bias = rng.normal(size=n_world) * np.radians(az_bias_deg)
    w_el_bias = rng.normal(size=n_world) * np.radians(el_bias_deg)

    # dynamic objects: rigid clusters of ~24 points on straight paths
    dyn_centers = rng.uniform(-extent * 0.6, extent * 0.6, size=(n_dynamic, 3))
    if n_dynamic:
        dyn_centers[:, 2] = rng.uniform(0.5, 2.0, n_dynamic)
    dyn_dirs = rng.normal(size=(n_dynamic, 3))
    if n_dynamic:
        dyn_dirs[:, 2] = 0.0
        dyn_dirs /= np.maximum(np.linalg.norm(dyn_dirs, axis=1, keepdims=True), 1e-9)
    dyn_vels = dyn_dirs * dynamic_speed
    dyn_template = rng.normal(size=(n_dynamic, 24, 3)) * np.array([1.5, 0.8, 0.6])
    d_az_bias = rng.normal(size=n_dynamic * 24) * np.radians(az_bias_deg)
    d_el_bias = rng.normal(size=n_dynamic * 24) * np.radians(el_bias_deg)

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

    seq = RadarSequence.from_frames(
        frames, np.asarray(imu_t), np.asarray(imu_a), np.asarray(imu_g),
        gt=(times.copy(), poses.copy()),
    )
    if baro:
        bt = np.arange(times[0], times[-1], 0.1)
        seq.baro_stamps = bt
        seq.baro_alt = np.full_like(bt, height) + rng.normal(size=len(bt)) * baro_noise
    return seq, world


def load_pairs(batch: int, capacity: int, device="cuda", seed: int = 0):
    """``bench.py``'s protocol: ``batch`` consecutive frame pairs (source =
    frame i, target = frame i-1) of one course (radius 14 m, omega 0.22),
    padded to ``capacity``.

    Returns (src_xyz [B,N,3] f32, src_mask [B,N], tgt_xyz, tgt_mask,
    gt_rel [B,4,4] numpy float64: the true source->target transforms).
    """
    dev = resolve(device)
    seq, _ = simulate_sequence(
        seed=seed, n_frames=batch + 1, capacity=capacity, radius=14.0, omega=0.22, baro=False
    )
    gt = seq.gt_poses
    xyz = np.zeros((batch + 1, capacity, 3), np.float64)
    mask = np.zeros((batch + 1, capacity), bool)
    for i in range(batch + 1):
        f = seq.frame(i)
        n = min(len(f["xyz"]), capacity)
        xyz[i, :n] = f["xyz"][:n]
        mask[i, :n] = True
    xyz_t = torch.as_tensor(xyz, dtype=torch.float32).to(dev)
    mask_t = torch.as_tensor(mask).to(dev)
    rel = np.stack([np.linalg.inv(gt[i - 1]) @ gt[i] for i in range(1, batch + 1)])
    return xyz_t[1:], mask_t[1:], xyz_t[:-1], mask_t[:-1], rel
