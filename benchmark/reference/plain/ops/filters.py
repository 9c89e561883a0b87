"""Mask-updating scan filters (port of ``rivslam_tpu/ops/filters.py``).

Each filter is pure: RadarCloud -> RadarCloud with a tighter mask (the
bilateral filter smooths intensity instead). Shapes never change.
"""

from __future__ import annotations

import torch

from benchmark.reference.plain.core.config import PreprocessConfig
from benchmark.reference.plain.core.pointcloud import RadarCloud, masked_xyz
from benchmark.reference.plain.ops import knn


def nan_filter(cloud: RadarCloud) -> RadarCloud:
    """Drop non-finite points (reference: removeNaNFromPointCloud)."""
    return cloud.and_mask(torch.all(torch.isfinite(cloud.xyz), dim=-1))


def power_filter(cloud: RadarCloud, threshold: float) -> RadarCloud:
    """Power/SNR gate (preprocessing_nodelet.cpp:667-700, power_threshold)."""
    return cloud.and_mask(cloud.intensity > threshold)


def distance_filter(cloud: RadarCloud, cfg: PreprocessConfig) -> RadarCloud:
    """Range annulus + z band (preprocessing_nodelet.cpp:881-905)."""
    d = torch.linalg.norm(cloud.xyz, dim=-1)
    z = cloud.xyz[..., 2]
    keep = (
        (d > cfg.distance_near_thresh)
        & (d < cfg.distance_far_thresh)
        & (z < cfg.z_high_thresh)
        & (z > cfg.z_low_thresh)
    )
    return cloud.and_mask(keep)


def radius_outlier_removal(cloud: RadarCloud, radius: float, min_neighbors: int) -> RadarCloud:
    """pcl::RadiusOutlierRemoval semantics (launch: RADIUS 0.5 / 1)."""
    counts = knn.radius_count(masked_xyz(cloud), cloud.mask, radius)
    return cloud.and_mask(counts >= min_neighbors)


def statistical_outlier_removal(cloud: RadarCloud, mean_k: int, stddev_mult: float) -> RadarCloud:
    """pcl::StatisticalOutlierRemoval semantics (launch: 30 / 1.2): drop
    points whose mean distance to their k nearest neighbours exceeds the
    valid points' mean + stddev_mult * std."""
    xyz = masked_xyz(cloud)
    _, d2 = knn.knn(xyz, xyz, cloud.mask, mean_k + 1)  # includes self at d=0
    d = torch.sqrt(torch.clamp_min(d2[..., 1:], 0.0))
    valid_nb = torch.isfinite(d)
    mean_d = torch.sum(torch.where(valid_nb, d, 0.0), dim=-1) / torch.clamp_min(
        torch.sum(valid_nb, dim=-1), 1
    )
    m = cloud.mask
    n = torch.clamp_min(torch.sum(m), 1)
    mu = torch.sum(torch.where(m, mean_d, 0.0)) / n
    var = torch.sum(torch.where(m, (mean_d - mu) ** 2, 0.0)) / n
    return cloud.and_mask(mean_d <= mu + stddev_mult * torch.sqrt(var))


def bilateral_filter(cloud: RadarCloud, sigma_s: float, sigma_r: float) -> RadarCloud:
    """pcl::BilateralFilter semantics (sigma_s=5, sigma_r=0.03): smooth each
    point's intensity by a spatial x intensity-difference Gaussian over its
    neighbourhood, in one masked [N, N] pass. Geometry is untouched."""
    xyz = masked_xyz(cloud)
    d2 = knn.pairwise_sqdist(xyz, xyz)
    w_s = torch.exp(-d2 / (2.0 * sigma_s * sigma_s))
    di = cloud.intensity[..., :, None] - cloud.intensity[..., None, :]
    w_r = torch.exp(-(di * di) / (2.0 * sigma_r * sigma_r))
    w = w_s * w_r * cloud.mask[..., None, :]
    num = torch.einsum("...nm,...m->...n", w, cloud.intensity)
    den = torch.clamp_min(torch.sum(w, dim=-1), 1e-12)
    return cloud.replace(intensity=torch.where(cloud.mask, num / den, cloud.intensity))
