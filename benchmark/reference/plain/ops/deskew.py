"""Rotational deskew of a radar scan from the gyro rate (port of
``rivslam_tpu/ops/deskew.py``; preprocessing_nodelet.cpp:914-975).

Point i is rotated by exp(dt_i * omega) with dt_i = scan_period * i / N and
omega the angular velocity at scan start, in the sensor frame.
"""

from __future__ import annotations

import torch

from benchmark.reference.plain.core import lie
from benchmark.reference.plain.core.pointcloud import RadarCloud


def deskew(cloud: RadarCloud, ang_vel: torch.Tensor, scan_period: float = 0.1) -> RadarCloud:
    """ang_vel: [3] rad/s. The reference flips its sign and rotates by the
    inverse small-angle quaternion; both flips give exp(+dt_i * omega)."""
    n = cloud.capacity
    dt = scan_period * torch.arange(n, dtype=cloud.xyz.dtype, device=cloud.xyz.device) / n
    w = -ang_vel  # reference: ang_v *= -1
    R = lie.so3_exp(-dt[:, None] * w[None, :])  # [N, 3, 3]
    xyz = torch.einsum("nij,nj->ni", R, cloud.xyz)
    return cloud.replace(xyz=torch.where(cloud.mask[:, None], xyz, cloud.xyz))
