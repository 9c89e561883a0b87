"""Map cloud generation, MapCloudGenerator parity (port of
``rivslam_tpu/backend/map.py``).

Reference (src/radar_graph_slam/map_cloud_generator.cpp:22-52): concatenate
keyframe clouds under their optimized poses with a <50 m range filter, then
octree occupied-voxel-center downsampling. Here: one batched transform of
the stacked keyframe clouds and the voxel grid of ``ops/voxel`` (voxel
centers, the octree's occupied-center semantics, not centroids), on the
tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

from rivslam_tpu_torch.core.pointcloud import RadarCloud
from rivslam_tpu_torch.ops import voxel

MAX_KEYFRAME_RANGE = 50.0  # map_cloud_generator.cpp:25


def assemble_map(
    kf_xyz: torch.Tensor,  # [K, N, 3] keyframe clouds (sensor frame)
    kf_mask: torch.Tensor,  # [K, N]
    poses: torch.Tensor,  # [K, 4, 4] optimized poses
    resolution: float = 0.05,
    out_capacity: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (map_xyz [V,3] voxel centers, valid [V]); V = out_capacity."""
    K, N, _ = kf_xyz.shape
    dt = torch.promote_types(kf_xyz.dtype, poses.dtype)  # as jnp.einsum promotes
    kf_xyz, poses = kf_xyz.to(dt), poses.to(dt)
    mask = kf_mask & (torch.linalg.norm(kf_xyz, dim=-1) < MAX_KEYFRAME_RANGE)
    world = torch.einsum("kij,knj->kni", poses[:, :3, :3], kf_xyz) + poses[:, None, :3, 3]
    flat_xyz = world.reshape(K * N, 3)
    zeros = torch.zeros(K * N, dtype=flat_xyz.dtype, device=flat_xyz.device)
    cloud = RadarCloud(xyz=flat_xyz, doppler=zeros, intensity=zeros, mask=mask.reshape(K * N))
    ds = voxel.voxel_downsample(cloud, resolution, K * N if out_capacity is None else out_capacity)
    # occupied-voxel CENTER semantics (octree), not centroid
    centers = (torch.floor(ds.xyz / resolution) + 0.5) * resolution
    return torch.where(ds.mask[:, None], centers, 0.0), ds.mask


def save_map_pcd(path: str, xyz: np.ndarray, zero_utm: np.ndarray | None = None,
                 apply_utm_offset: bool = False) -> None:
    """Write an ASCII PCD (SaveMap service output format parity).

    ``zero_utm`` + ``apply_utm_offset`` mirror the SaveMap service's UTM
    handling (radar_graph_slam_nodelet.cpp:1252-1263): with req.utm and a
    known zero_utm the points are shifted into absolute UTM coordinates, and
    a ``<dest>.utm`` sidecar records the origin either way."""
    xyz = np.asarray(xyz, np.float64)
    if zero_utm is not None and apply_utm_offset:
        xyz = xyz + np.asarray(zero_utm, np.float64)[None, :]
    if zero_utm is not None:
        with open(path + ".utm", "w") as f:
            f.write("%.6f %.6f %.6f\n" % tuple(np.asarray(zero_utm, np.float64)))
    n = xyz.shape[0]
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n"
        )
        for p in xyz:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def load_pcd(path: str) -> np.ndarray:
    """Read an ASCII xyz PCD back."""
    pts = []
    with open(path) as f:
        in_data = False
        for line in f:
            if in_data:
                pts.append([float(v) for v in line.split()[:3]])
            elif line.startswith("DATA"):
                in_data = True
    return np.asarray(pts)
