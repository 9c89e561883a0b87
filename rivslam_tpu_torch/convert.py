"""Carry state from the JAX package into the port.

SLAM has no weights: its state is point clouds, prepared covariances,
configuration and pose guesses. These helpers take the JAX package's values
as numpy arrays (``np.asarray`` of a JAX array) or plain dicts and build the
port's counterparts, so both packages can compute on the same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.core.device import resolve
from rivslam_tpu_torch.core.pointcloud import RadarCloud
from rivslam_tpu_torch.frontend.apdgicp import PreparedCloud


def tensor(x, device="cuda", dtype=None) -> torch.Tensor:
    """A numpy array (or anything np.asarray takes) as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(resolve(device))


def radar_cloud(xyz, doppler, intensity, mask, device="cuda") -> RadarCloud:
    """A RadarCloud from the fields of a JAX ``RadarCloud``."""
    return RadarCloud(
        xyz=tensor(xyz, device),
        doppler=tensor(doppler, device),
        intensity=tensor(intensity, device),
        mask=tensor(mask, device, torch.bool),
    )


def prepared_cloud(xyz, mask, cov, device="cuda") -> PreparedCloud:
    """A PreparedCloud from the fields of a JAX ``PreparedCloud``."""
    return PreparedCloud(
        xyz=tensor(xyz, device), mask=tensor(mask, device, torch.bool),
        cov=tensor(cov, device),
    )


def registration_config(fields: dict) -> RegistrationConfig:
    """A RegistrationConfig from ``dataclasses.asdict`` of the reference's.

    Raises TypeError on a field the port's config does not know.
    """
    return RegistrationConfig(**fields)


def guess(T, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """4x4 (or [B, 4, 4]) pose guesses."""
    T = tensor(T, device, dtype)
    if T.shape[-2:] != (4, 4):
        raise ValueError(f"a guess is [..., 4, 4], got {tuple(T.shape)}")
    return T
