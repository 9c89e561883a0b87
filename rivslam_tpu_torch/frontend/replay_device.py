"""The odometry front end over a whole stacked sequence (port of
``rivslam_tpu/frontend/replay_device.py``).

The odometry is serial: each frame registers against the rolling keyframe.
The reference runs the whole front end (covariance prepare, registration,
keyframe machinery) as one ``lax.scan``; here the same steps run frame by
frame on device tensors, each frame's outputs written into [F, ...]
tensors, with no host read beyond the registration's own (one per outer
LM iteration).
"""

from __future__ import annotations

import torch

from rivslam_tpu_torch.core.config import OdometryConfig, RegistrationConfig
from rivslam_tpu_torch.core.device import resolve
from rivslam_tpu_torch.frontend import apdgicp, odometry


def replay_odometry(
    xyz,  # [F, N, 3] stacked frames
    mask,  # [F, N]
    ego_vel,  # [F, 3]
    times,  # [F]
    odo_cfg: OdometryConfig,
    reg_cfg: RegistrationConfig,
    device="cuda",
):
    """Frames 1..F-1 through the odometry; frame 0 initializes. Inputs are
    arrays or tensors; the working dtype is that of ``xyz``.

    Returns (poses [F,4,4], is_keyframe [F], converged [F]) on the device."""
    dev = resolve(device)
    xyz = torch.as_tensor(xyz).to(dev)
    dtype = xyz.dtype
    mask = torch.as_tensor(mask).to(dev)
    ego_vel = torch.as_tensor(ego_vel).to(device=dev, dtype=dtype)
    times = torch.as_tensor(times).to(device=dev, dtype=dtype)
    F = xyz.shape[0]
    poses = torch.empty((F, 4, 4), dtype=dtype, device=dev)
    poses[0] = torch.eye(4, dtype=dtype, device=dev)
    is_kf = torch.ones(F, dtype=torch.bool, device=dev)
    converged = torch.ones(F, dtype=torch.bool, device=dev)
    state = odometry.init_state(apdgicp.prepare(xyz[0], mask[0], reg_cfg, device=dev), times[0], dtype=dtype)
    for i in range(1, F):
        prepared = apdgicp.prepare(xyz[i], mask[i], reg_cfg, device=dev)
        state, out = odometry.step(state, prepared, ego_vel[i], times[i], odo_cfg, reg_cfg)
        poses[i] = out.odom
        is_kf[i] = out.is_keyframe
        converged[i] = out.reg.converged
    return poses, is_kf, converged
