"""Radar ego-velocity estimation (REVE), vectorised RANSAC + least squares
(port of ``rivslam_tpu/frontend/reve.py``; radar_ego_velocity_estimator.cpp).

All RANSAC hypotheses are drawn at once: each row of the ``uniforms``
argument scores every target, and a hypothesis takes the targets with the
``n_ransac_points`` highest scores among the valid ones. The reference
draws those scores from its frame's ``jax.random`` key; here the caller
hands them in (the Engine draws them from the same key chain,
``core/prng.py``, bit for bit), so two runs given the same scores test the
same hypotheses. The model is doppler_i = d_i . v with d_i the unit direction.

Reference quirks kept: the 70th-percentile |doppler| zero-velocity gate
(cpp:101-117), "regard outliers as inliers" above a 5% outlier ratio
(cpp:216-221), sigma gating on the final solve (cpp:278-294).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.plain.core.config import ReveConfig
from benchmark.reference.plain.core.pointcloud import RadarCloud


@dataclasses.dataclass(frozen=True)
class EgoVelocityResult:
    v: torch.Tensor  # [3] estimated sensor-frame velocity
    sigma: torch.Tensor  # [3] per-axis std dev
    success: torch.Tensor  # [] bool
    zero_velocity: torch.Tensor  # [] bool
    inlier_mask: torch.Tensor  # [N] bool: static targets (outliers ~ dynamic objects)


def top_scores(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores per row, equal scores lower index
    first (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def _masked_lsq(dirs: torch.Tensor, dop: torch.Tensor, w: torch.Tensor):
    """Weighted (0/1) normal-equation solve of dirs @ v = dop.
    Returns (v [..., 3], HtH [..., 3, 3], n [...])."""
    wd = dirs * w[..., None]
    HtH = torch.einsum("...ni,...nj->...ij", wd, dirs)
    Hty = torch.einsum("...ni,...n->...i", wd, dop)
    # Tikhonov epsilon keeps degenerate hypothesis solves finite
    eye = torch.eye(3, dtype=dirs.dtype, device=dirs.device) * 1e-9
    v = torch.linalg.solve_ex(HtH + eye, Hty[..., None])[0][..., 0]
    return v, HtH, torch.sum(w, dim=-1)


def estimate_ego_velocity(
    cloud: RadarCloud, cfg: ReveConfig, uniforms: torch.Tensor
) -> EgoVelocityResult:
    """Single-scan ego velocity. ``uniforms``: [cfg.ransac_iter, N] scores
    in [0, 1) that pick the RANSAC hypotheses (see the module doc)."""
    xyz = cloud.xyz
    dtype, dev = xyz.dtype, xyz.device
    n = cloud.capacity
    iters = max(cfg.ransac_iter, 1)
    if tuple(uniforms.shape) != (iters, n):
        raise ValueError(f"uniforms must be [{iters}, {n}], got {tuple(uniforms.shape)}")

    r = torch.linalg.norm(xyz, dim=-1)
    azimuth = torch.atan2(xyz[..., 1], xyz[..., 0])
    elevation = torch.atan2(torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2), xyz[..., 2]) - math.pi / 2
    valid = (
        cloud.mask
        & (r > cfg.min_dist)
        & (r < cfg.max_dist)
        & (cloud.intensity > cfg.min_db)
        & (torch.abs(azimuth) < math.radians(cfg.azimuth_thresh_deg))
        & (torch.abs(elevation) < math.radians(cfg.elevation_thresh_deg))
    )
    dirs = xyz / torch.clamp_min(r, 1e-9)[..., None]
    dop = cloud.doppler * cfg.doppler_velocity_correction_factor
    n_valid = torch.sum(valid)

    # ---- zero-velocity gate: q-th smallest |doppler| with q = N*(1-outlier%)
    sorted_dop = torch.sort(torch.where(valid, torch.abs(dop), torch.inf)).values
    q = torch.floor(n_valid.to(dtype) * (1.0 - cfg.allowed_outlier_percentage)).to(torch.int64)
    median = sorted_dop[torch.clamp(q, 0, n - 1)]
    is_zero = median < cfg.thresh_zero_velocity
    zero_v = torch.zeros(3, dtype=dtype, device=dev)
    zero_sigma = torch.tensor(
        [cfg.sigma_zero_velocity_x, cfg.sigma_zero_velocity_y, cfg.sigma_zero_velocity_z],
        dtype=dtype, device=dev,
    )
    zero_inliers = valid & (torch.abs(dop) < cfg.thresh_zero_velocity)

    # ---- RANSAC over all hypotheses at once
    scores = torch.where(valid[None, :], uniforms.to(dev), -torch.inf)
    samp_idx = top_scores(scores, cfg.n_ransac_points)  # [iters, k]
    v_hyp, _, _ = _masked_lsq(dirs[samp_idx], dop[samp_idx], valid[samp_idx].to(dtype))
    err = torch.abs(dop[None, :] - torch.einsum("nd,id->in", dirs, v_hyp))  # [iters, N]
    inl = valid[None, :] & (err < cfg.inlier_thresh)
    n_inl = torch.sum(inl, dim=-1)
    ratio = (n_valid - n_inl).to(dtype) / torch.clamp_min(n_valid, 1).to(dtype)
    inl = torch.where((ratio > 0.05)[:, None], valid[None, :], inl)
    n_inl = torch.sum(inl, dim=-1)
    best_inl = inl[torch.argmax(n_inl)]

    # ---- final masked solve with sigma estimation (cpp:252-303)
    w = best_inl.to(dtype)
    v_fin, HtH, n_in = _masked_lsq(dirs, dop, w)
    e = (torch.einsum("nd,d->n", dirs, v_fin) - dop) * w
    ete = torch.sum(e * e)
    HtH_inv = torch.linalg.inv_ex(HtH + torch.eye(3, dtype=dtype, device=dev) * 1e-9)[0]
    C = ete * HtH_inv / torch.clamp_min(n_in - 3.0, 1.0)
    var = torch.diagonal(C)
    offset = torch.tensor(
        [cfg.sigma_offset_radar_x, cfg.sigma_offset_radar_y, cfg.sigma_offset_radar_z],
        dtype=dtype, device=dev,
    )
    sigma = torch.sqrt(torch.clamp_min(var, 0.0)) + offset
    sigma_ok = (sigma[0] < cfg.max_sigma_x) & (sigma[1] < cfg.max_sigma_y) & (sigma[2] < cfg.max_sigma_z)
    ransac_ok = torch.all(var >= 0.0) & sigma_ok & (n_valid > 2) & (torch.max(n_inl) > 0)

    return EgoVelocityResult(
        v=torch.where(is_zero, zero_v, v_fin),
        sigma=torch.where(is_zero, zero_sigma, sigma),
        success=torch.where(is_zero, n_valid > 2, ransac_ok),
        zero_velocity=is_zero & (n_valid > 2),
        inlier_mask=torch.where(is_zero, zero_inliers, best_inl),
    )
