"""K3: exact masked 1-nearest-neighbour search (first-index argmin + d2).

Counterpart of ``rivslam_tpu/ops/pallas_nn.py``'s ``nearest_neighbor_pallas``
(the ``_nn_kernel`` TPU kernel), batched over B problems:

    nearest_neighbor(query [B,N,3], ref [B,M,3], ref_mask [B,M] bool)
        -> (idx [B,N] int32, d2 [B,N])

d2 is the masked minimum of |q|^2 + |r|^2 - 2 q.r, unclamped, and idx the
first index reaching it; where a problem has no valid ref, d2 is 1e30 and
idx 0. This is the TPU kernel's contract, not quite ``ops/knn``'s (which
clamps at 0 and gives +inf): callers restore that themselves.

``nearest_neighbor`` runs K3's plain twin, ``nearest_neighbor_plain``:
plain torch, the kernel's distance arithmetic (each product and sum rounded
on its own) and the TPU kernel's tiles of 512 refs. The reference launches
no kernel.
"""

from __future__ import annotations

import torch

BIG = 1e30
TILE_M = 512  # the TPU kernel's ref tile (pallas_nn.TILE_M)

def _check(query, ref, ref_mask) -> tuple[int, int, int]:
    if query.ndim != 3 or query.shape[-1] != 3:
        raise ValueError(f"query must be [B, N, 3], got {tuple(query.shape)}")
    B, N, _ = query.shape
    if ref.ndim != 3 or ref.shape[0] != B or ref.shape[-1] != 3:
        raise ValueError(f"ref must be [B={B}, M, 3], got {tuple(ref.shape)}")
    M = ref.shape[1]
    if tuple(ref_mask.shape) != (B, M) or ref_mask.dtype != torch.bool:
        raise ValueError(
            f"ref_mask must be bool [B={B}, M={M}], got {ref_mask.dtype} "
            f"{tuple(ref_mask.shape)}"
        )
    devices = {t.device for t in (query, ref, ref_mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return B, N, M


def nearest_neighbor(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's plain twin on every device: the reference launches no kernel."""
    _check(query, ref, ref_mask)
    return nearest_neighbor_plain(query, ref, ref_mask)


def nearest_neighbor_plain(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K3, on any device and dtype.

    Follows ``_nn_kernel`` tile by tile (512 refs): per tile the first-index
    argmin, kept only where the tile's minimum is strictly below the running
    one. A masked ref's distance is exactly 1e30 and never replaces it.
    """
    _check(query, ref, ref_mask)
    B, N, _ = query.shape
    qx, qy, qz = (query[..., k, None] for k in range(3))  # [B, N, 1]
    qn = qx * qx + qy * qy + qz * qz
    best = torch.full((B, N), BIG, dtype=query.dtype, device=query.device)
    idx = torch.zeros((B, N), dtype=torch.int32, device=query.device)
    for s in range(0, ref.shape[1], TILE_M):
        r = ref[:, s:s + TILE_M]
        m = ref_mask[:, None, s:s + TILE_M]  # [B, 1, TM]
        rx, ry, rz = (r[:, None, :, k] for k in range(3))  # [B, 1, TM]
        rn = rx * rx + ry * ry + rz * rz
        cross = qx * rx + qy * ry + qz * rz
        d2 = torch.where(m, (qn + rn) - 2.0 * cross, BIG)  # [B, N, TM]
        loc = torch.argmin(d2, dim=-1)
        tmin = torch.take_along_dim(d2, loc[..., None], dim=-1)[..., 0]
        upd = tmin < best
        best = torch.where(upd, tmin, best)
        idx = torch.where(upd, (loc + s).to(torch.int32), idx)
    return idx, best
