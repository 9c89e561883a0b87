"""Edge information matrices from registration quality (port of
``rivslam_tpu/factors/infomat.py``; information_matrix_calculator.cpp:29-86).

fitness = mean squared nearest-neighbour distance between the clouds under
the relative pose; an exponential gain maps it to a variance in [min, max];
the 6x6 information is diag(1/w_q, 1/w_x) in the (rot, trans) order of the
residuals. The nearest-neighbour pass is K3 (``ops/nn_argmin``).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.plain.core import lie
from benchmark.reference.plain.core.config import BackendConfig
from benchmark.reference.plain.core.pointcloud import SENTINEL
from benchmark.reference.plain.ops import nn_argmin

FITNESS_THRESH = 0.5  # the reference ctor default "fitness_score_thresh"


def fitness_score(xyz1, mask1, xyz2, mask2, relpose, max_range: float = math.inf) -> torch.Tensor:
    """Mean squared NN distance of cloud2 (moved by relpose) against cloud1
    (information_matrix_calculator.cpp:55-86), for one pair [N, 3] / [M, 3].

    K3 gives the TPU kernel's d2 (unclamped, 1e30 without a valid ref); the
    score restores what the reference's ``knn.nearest_neighbor`` hands its
    fitness: d2 clamped at 0, and +inf when cloud1 has no valid point. So an
    all-masked cloud1 (the first frame's empty previous slot) scores inf, as
    in the reference, and the information stays finite.
    """
    moved = lie.transform_points(relpose, xyz2)
    ref = torch.where(mask1[..., None], xyz1, SENTINEL)
    _, d2 = nn_argmin.nearest_neighbor(
        moved[None].contiguous(), ref[None].contiguous(), mask1[None].contiguous()
    )
    d2 = torch.where(torch.any(mask1), torch.clamp_min(d2[0], 0.0), torch.inf)
    ok = mask2 & (d2 <= max_range)
    nr = torch.sum(ok)
    score = torch.sum(torch.where(ok, d2, 0.0)) / torch.clamp_min(nr, 1)
    return torch.where(nr > 0, score, torch.finfo(xyz1.dtype).max)


def _weight(a, max_x, min_y, max_y, x):
    """hpp:39-42."""
    y = (1.0 - torch.exp(-a * x)) / (1.0 - math.exp(-a * max_x))
    return min_y + (max_y - min_y) * y


def calc_information_matrix(
    xyz1, mask1, xyz2, mask2, relpose, cfg: BackendConfig, scaled: bool = True
) -> torch.Tensor:
    """calc_information_matrix parity, translation rows in the bottom-right
    block (the residual order is (rot, trans)). ``scaled`` keeps the
    reference's 1e-8 variance-scaling quirk (cpp:44-45), as the window
    solve does."""
    eye = torch.eye(6, dtype=xyz1.dtype, device=xyz1.device)
    if cfg.use_const_inf_matrix:
        scale = [1.0 / cfg.const_stddev_q] * 3 + [1.0 / cfg.const_stddev_x] * 3
        return eye * torch.tensor(scale, dtype=xyz1.dtype, device=xyz1.device)
    f = fitness_score(xyz1, mask1, xyz2, mask2, relpose, cfg.fitness_score_max_range)
    quirk = 1.0e-8 if scaled else 1.0
    w_x = quirk * _weight(cfg.var_gain_a, FITNESS_THRESH, cfg.min_stddev_x**2, cfg.max_stddev_x**2, f)
    w_q = quirk * _weight(cfg.var_gain_a, FITNESS_THRESH, cfg.min_stddev_q**2, cfg.max_stddev_q**2, f)
    diag = torch.stack([1.0 / w_q] * 3 + [1.0 / w_x] * 3)
    return eye * diag
