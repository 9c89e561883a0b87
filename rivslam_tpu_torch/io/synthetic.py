"""Synthetic radar world generator (numpy-only port of the parts of
``rivslam_tpu/io/synthetic.py`` the scan-match benchmark protocol needs).

``make_world``, ``observe`` and the radar frames of ``simulate_sequence``
draw exactly the reference's random numbers in the reference's order, so
the same seed gives the same arrays (the tests hold them equal).
``load_pairs`` is the counterpart of ``bench.py``'s protocol: B consecutive
frame pairs of one simulated course, padded to a capacity, with the ground
truth relative transform of each pair.
"""

from __future__ import annotations

import numpy as np
import torch

from rivslam_tpu_torch.core.device import resolve
from rivslam_tpu_torch.core.pointcloud import RadarCloud


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


def simulate_frames(
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
    doppler_noise: float = 0.05,
    world_points: int = 20000,
    extent: float = 40.0,
):
    """The radar frames and ground-truth poses of the reference's
    ``simulate_sequence`` with its defaults for dynamic objects and
    Cartesian noise (none), and without the IMU and barometer streams it
    draws after the frames.

    Returns (frames: list of dicts with stamp/xyz/doppler/intensity,
    gt_poses [F, 4, 4] world_T_sensor).
    """
    rng = np.random.default_rng(seed)
    world = make_world(rng, n_points=world_points, extent=extent)
    times, poses, vels = circular_trajectory(
        n_frames, radius=radius, height=height, dt=dt, omega=omega
    )
    n_world = len(world)
    w_az_bias = rng.normal(size=n_world) * np.radians(az_bias_deg)
    w_el_bias = rng.normal(size=n_world) * np.radians(el_bias_deg)

    frames = []
    half_fov = np.radians(fov_deg)
    for i in range(n_frames):
        R, t = poses[i][:3, :3], poses[i][:3, 3]
        v_local = R.T @ vels[i]
        local = (world - t) @ R
        r = np.linalg.norm(local, axis=1)
        vis = (r > 1.0) & (r < max_range)
        vis &= np.abs(np.arctan2(local[:, 1], local[:, 0])) < half_fov
        idx = np.where(vis)[0]
        strength = _strength(world[idx])
        # radar-equation range falloff: detections concentrate close-range
        det = strength - 25.0 * np.log10(np.maximum(r[idx], 1.0)) \
            + rng.normal(size=len(idx)) * 1.0
        if len(idx) > capacity:
            keep = np.argsort(-det)[:capacity]
            idx, strength = idx[keep], strength[keep]
        pts = local[idx]
        bias_az = w_az_bias[idx]
        bias_el = w_el_bias[idx]

        rr = np.linalg.norm(pts, axis=1)
        az = np.arctan2(pts[:, 1], pts[:, 0])
        el = np.arctan2(np.hypot(pts[:, 0], pts[:, 1]), pts[:, 2])
        dirs = pts / np.maximum(rr[:, None], 1e-9)
        dop = dirs @ v_local  # static targets
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
        intensity = strength + rng.normal(size=len(pts)) * 0.5
        frames.append(
            dict(stamp=float(times[i]), xyz=pts, doppler=dop, intensity=intensity)
        )
    return frames, poses


def load_pairs(batch: int, capacity: int, device="cuda", seed: int = 0):
    """``bench.py``'s protocol: ``batch`` consecutive frame pairs (source =
    frame i, target = frame i-1) of one course (radius 14 m, omega 0.22),
    padded to ``capacity``.

    Returns (src_xyz [B,N,3] f32, src_mask [B,N], tgt_xyz, tgt_mask,
    gt_rel [B,4,4] numpy float64: the true source->target transforms).
    """
    dev = resolve(device)
    frames, gt = simulate_frames(
        seed=seed, n_frames=batch + 1, capacity=capacity, radius=14.0, omega=0.22
    )
    xyz = np.zeros((batch + 1, capacity, 3), np.float64)
    mask = np.zeros((batch + 1, capacity), bool)
    for i, f in enumerate(frames):
        n = min(len(f["xyz"]), capacity)
        xyz[i, :n] = f["xyz"][:n]
        mask[i, :n] = True
    xyz_t = torch.as_tensor(xyz, dtype=torch.float32).to(dev)
    mask_t = torch.as_tensor(mask).to(dev)
    rel = np.stack([np.linalg.inv(gt[i - 1]) @ gt[i] for i in range(1, batch + 1)])
    return xyz_t[1:], mask_t[1:], xyz_t[:-1], mask_t[:-1], rel
