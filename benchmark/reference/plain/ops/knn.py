"""Masked nearest-neighbour searches, plain torch (port of ``rivslam_tpu/ops/knn.py``).

Brute force in the expanded form ||a-b||^2 = |a|^2 + |b|^2 - 2 a.b with the
cross term one batched matmul (full float32; the port keeps TF32 off).
"""

from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., M, 3] -> [..., N, M] squared distances."""
    cross = torch.einsum("...nd,...md->...nm", a, b)
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    d2 = na[..., :, None] + nb[..., None, :] - 2.0 * cross
    return torch.clamp_min(d2, 0.0)


def nearest_neighbor(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """For each query point, the exact nearest valid ref point.

    Returns (idx [..., N] int32, sqdist [..., N]). Invalid refs never win
    (their distance is +inf); the first index wins a tie. If no valid ref
    exists idx is arbitrary and sqdist inf.
    """
    d2 = pairwise_sqdist(query, ref)
    d2 = torch.where(ref_mask[..., None, :], d2, torch.inf)
    idx = torch.argmin(d2, dim=-1)
    best = torch.take_along_dim(d2, idx[..., None], dim=-1)[..., 0]
    return idx.to(torch.int32), best


def knn(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest valid refs per query, ascending.

    Returns (idx [..., N, k] int32, sqdist [..., N, k]); invalid refs carry
    +inf. Equal distances keep the lower index first, as the reference's
    ``lax.top_k`` does: a stable sort, where ``torch.topk`` promises no
    order among ties.
    """
    d2 = pairwise_sqdist(query, ref)
    d2 = torch.where(ref_mask[..., None, :], d2, torch.inf)
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    return idx[..., :k].to(torch.int32), d2s[..., :k]


def radius_count(points: torch.Tensor, mask: torch.Tensor, radius: float) -> torch.Tensor:
    """Number of OTHER valid points within ``radius`` of each point (one
    [N, N] pass)."""
    d2 = pairwise_sqdist(points, points)
    n = points.shape[-2]
    within = (d2 <= radius * radius) & mask[..., None, :]
    within = within & ~torch.eye(n, dtype=torch.bool, device=points.device)
    return torch.sum(within, dim=-1)
