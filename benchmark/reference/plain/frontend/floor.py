"""Ground-plane (floor) detection, batched-hypothesis RANSAC plane fit
(port of ``rivslam_tpu/frontend/floor.py``; floor_detection_nodelet.cpp).

Tilt compensation and height clipping (:156-169), the 10-NN normal filter
(:280-307), all ``ransac_iterations`` 3-point hypotheses scored at once,
then a masked PCA refit over the best hypothesis' inliers and the
verticality check (:197-208). The hypotheses are picked by the caller's
``uniforms`` scores, as in ``frontend/reve.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.plain.core import lie
from benchmark.reference.plain.core.config import FloorConfig
from benchmark.reference.plain.core.pointcloud import SENTINEL
from benchmark.reference.plain.frontend.reve import top_scores
from benchmark.reference.plain.ops import eig3, knn


@dataclasses.dataclass(frozen=True)
class FloorResult:
    coeffs: torch.Tensor  # [4] plane (a,b,c,d): a x + b y + c z + d = 0, |n|=1
    found: torch.Tensor  # [] bool
    num_inliers: torch.Tensor  # [] int32


def detect_floor(
    xyz: torch.Tensor, mask: torch.Tensor, cfg: FloorConfig, uniforms: torch.Tensor
) -> FloorResult:
    """``uniforms``: [cfg.ransac_iterations, N] hypothesis scores."""
    dtype, dev = xyz.dtype, xyz.device
    n = xyz.shape[0]
    if tuple(uniforms.shape) != (cfg.ransac_iterations, n):
        raise ValueError(
            f"uniforms must be [{cfg.ransac_iterations}, {n}], got {tuple(uniforms.shape)}"
        )

    R_tilt = lie.so3_exp(torch.tensor([0.0, math.radians(cfg.tilt_deg), 0.0], dtype=dtype, device=dev))
    pts = xyz @ R_tilt.T
    z = pts[:, 2]
    m = mask & (z > -(cfg.sensor_height + cfg.height_clip_range))
    m = m & (z < -(cfg.sensor_height - cfg.height_clip_range))

    if cfg.use_normal_filtering:
        # masked rows sit at the sentinel; their neighbour order is
        # irrelevant, since they stay masked
        spts = torch.where(m[:, None], pts, SENTINEL)
        idx, d2 = knn.knn(spts, spts, m, 10)
        nb = pts[idx]  # [N, 10, 3]
        w = torch.isfinite(d2).to(dtype)
        wn = torch.clamp_min(w.sum(-1, keepdim=True), 1.0)
        mean = (nb * w[..., None]).sum(-2) / wn
        cent = (nb - mean[:, None, :]) * w[..., None]
        cov = torch.einsum("nki,nkj->nij", cent, cent) / wn[..., None]
        normal = eig3.smallest_eigenvector_sym3(cov)
        m = m & (torch.abs(normal[:, 2]) > math.cos(math.radians(cfg.normal_filter_thresh_deg)))

    n_valid = torch.sum(m)

    scores = torch.where(m[None, :], uniforms.to(dev), -torch.inf)
    p = pts[top_scores(scores, 3)]  # [h, 3, 3]
    nrm = torch.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], dim=-1)
    nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1, keepdim=True), 1e-12)
    d0 = -torch.einsum("hi,hi->h", nrm, p[:, 0])
    dist = torch.abs(torch.einsum("hi,ni->hn", nrm, pts) + d0[:, None])  # [h, N]
    inl = m[None, :] & (dist < cfg.ransac_distance_thresh)
    n_inl = inl.sum(-1)
    best = torch.argmax(n_inl)
    best_inl = inl[best]

    # refine: masked PCA plane through the inlier centroid
    w = best_inl.to(dtype)
    wn = torch.clamp_min(w.sum(), 1.0)
    centroid = (pts * w[:, None]).sum(0) / wn
    cent = (pts - centroid) * w[:, None]
    C = cent.T @ cent / wn
    normal = torch.linalg.eigh(C).eigenvectors[:, 0]
    normal = torch.where(normal[2] < 0, -normal, normal)  # point +z like the reference
    d = -torch.dot(normal, centroid)

    vertical_ok = torch.abs(normal[2]) > math.cos(math.radians(cfg.floor_normal_thresh_deg))
    found = (n_inl[best] >= cfg.floor_pts_thresh) & vertical_ok & (n_valid > 3)
    coeffs = torch.cat([R_tilt.T @ normal, d[None]])  # un-tilt to the sensor frame
    return FloorResult(coeffs=coeffs, found=found, num_inliers=n_inl[best].to(torch.int32))
