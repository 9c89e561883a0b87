"""Navigation state {t, R, p, v, bg, ba} (port of ``rivslam_tpu/core/navstate.py``).

A plain dataclass of tensors; fields may carry leading batch dims.
"""

from __future__ import annotations

import dataclasses

import torch

GRAVITY = 9.80511  # reference: imu_preintegration.hpp:69, params.yaml imuGravity


@dataclasses.dataclass(frozen=True)
class NavState:
    t: torch.Tensor  # [] timestamp, seconds
    R: torch.Tensor  # [3,3] attitude (body->world)
    p: torch.Tensor  # [3] position, world
    v: torch.Tensor  # [3] velocity, world
    bg: torch.Tensor  # [3] gyro bias
    ba: torch.Tensor  # [3] accel bias
