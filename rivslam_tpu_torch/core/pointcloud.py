"""Fixed-capacity masked point clouds (port of ``rivslam_tpu/core/pointcloud.py``).

Every cloud is padded to a static capacity and carries a validity mask, so
the batched kernels downstream see only static shapes. Fields are torch
tensors; leading batch dims are allowed on all of them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rivslam_tpu_torch.core.device import resolve

SENTINEL = 1.0e6  # coordinate assigned to invalid points where useful


@dataclasses.dataclass(frozen=True)
class RadarCloud:
    """Masked radar point cloud.

    xyz:       [..., N, 3] cartesian points in sensor frame
    doppler:   [..., N]    radial (doppler) velocity, m/s, sign: + receding
    intensity: [..., N]    SNR / power (dataset dependent)
    mask:      [..., N]    bool validity
    """

    xyz: torch.Tensor
    doppler: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)

    def replace(self, **kw) -> "RadarCloud":
        return dataclasses.replace(self, **kw)

    def and_mask(self, keep: torch.Tensor) -> "RadarCloud":
        return self.replace(mask=self.mask & keep)

    @staticmethod
    def from_numpy(
        xyz: np.ndarray,
        capacity: int,
        doppler: np.ndarray | None = None,
        intensity: np.ndarray | None = None,
        dtype=torch.float32,
        device="cuda",
    ) -> "RadarCloud":
        """Host-side ingest: pad/truncate a variable-length scan to capacity."""
        dev = resolve(device)
        n = min(xyz.shape[0], capacity)
        out_xyz = np.zeros((capacity, 3), dtype=np.float64)
        out_dop = np.zeros((capacity,), dtype=np.float64)
        out_int = np.zeros((capacity,), dtype=np.float64)
        out_mask = np.zeros((capacity,), dtype=bool)
        out_xyz[:n] = xyz[:n]
        if doppler is not None:
            out_dop[:n] = doppler[:n]
        if intensity is not None:
            out_int[:n] = intensity[:n]
        out_mask[:n] = True
        return RadarCloud(
            xyz=torch.as_tensor(out_xyz, dtype=dtype, device=dev),
            doppler=torch.as_tensor(out_dop, dtype=dtype, device=dev),
            intensity=torch.as_tensor(out_int, dtype=dtype, device=dev),
            mask=torch.as_tensor(out_mask, device=dev),
        )


def compact(cloud: RadarCloud) -> RadarCloud:
    """Move valid points to the front (stable), keeping the capacity."""
    order = torch.argsort((~cloud.mask).to(torch.uint8), dim=-1, stable=True)  # valid first
    return RadarCloud(
        xyz=torch.take_along_dim(cloud.xyz, order[..., None], dim=-2),
        doppler=torch.take_along_dim(cloud.doppler, order, dim=-1),
        intensity=torch.take_along_dim(cloud.intensity, order, dim=-1),
        mask=torch.take_along_dim(cloud.mask, order, dim=-1),
    )


def masked_xyz(cloud: RadarCloud, sentinel: float = SENTINEL) -> torch.Tensor:
    """xyz with invalid rows pushed to a far sentinel (keeps NN searches honest)."""
    return torch.where(cloud.mask[..., None], cloud.xyz, sentinel)
