"""A frame's preprocessing, as the Engine's ``_preprocess`` runs it before
the odometry (port of ``rivslam_tpu/pipeline.py``'s frame step, cut to the
part the check runs): the filters, REVE's ego velocity with the frame's
RANSAC draws, dynamic-object removal, deskew, the distance filter, the
voxel grid, outlier removal, the floor and under-floor removal."""

from __future__ import annotations

import torch

from benchmark.reference.plain.core.config import EngineConfig
from benchmark.reference.plain.core.pointcloud import RadarCloud
from benchmark.reference.plain.frontend import floor, reve
from benchmark.reference.plain.ops import deskew, filters, voxel


def draw_shapes(cfg: EngineConfig, n: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The shapes of one frame's RANSAC scores, in the order they are
    drawn: REVE's, then the floor detector's, for a cloud of n points."""
    return (max(cfg.reve.ransac_iter, 1), n), (cfg.floor.ransac_iterations, n)


def preprocess(cfg: EngineConfig, cloud: RadarCloud, ang_vel: torch.Tensor, prev_floor: torch.Tensor, draws):
    """(the cloud the odometry and the backend take, the ego velocity, the
    floor, the floor in effect)."""
    p = cfg.preprocess
    cl = filters.nan_filter(cloud)
    cl = filters.power_filter(cl, p.power_threshold)
    ego = reve.estimate_ego_velocity(cl, cfg.reve, draws[0])
    if p.enable_dynamic_object_removal:
        cl = cl.and_mask(ego.inlier_mask | ~ego.success)
    if p.enable_deskew:
        cl = deskew.deskew(cl, ang_vel, scan_period=p.scan_period)
    if p.use_distance_filter:
        cl = filters.distance_filter(cl, p)
    if p.downsample_method == "VOXELGRID":
        cl = voxel.voxel_downsample(cl, p.downsample_resolution, cl.capacity)
    if p.outlier_removal_method == "RADIUS":
        cl = filters.radius_outlier_removal(cl, p.radius_radius, p.radius_min_neighbors)
    elif p.outlier_removal_method == "STATISTICAL":
        cl = filters.statistical_outlier_removal(cl, p.statistical_mean_k, p.statistical_stddev)
    elif p.outlier_removal_method == "BILATERAL":
        cl = filters.bilateral_filter(cl, p.bilateral_sigma_s, p.bilateral_sigma_r)
    fl = floor.detect_floor(cl.xyz, cl.mask, cfg.floor, draws[1])
    eff_floor = torch.where(fl.found, fl.coeffs, prev_floor)
    if p.enable_under_floor_removal:
        sd = cl.xyz @ eff_floor[:3] + eff_floor[3] + cfg.floor.floor_tolerance
        cl = cl.and_mask(sd > 0)
    return cl, ego, fl, eff_floor
