"""K1: fused masked nearest-neighbour distance + tie-averaged feature gather.

Counterpart of ``rivslam_tpu/ops/pallas_nn.py``'s ``fused_gather_pallas``
(the ``_gather_kernel`` TPU kernel), batched over B registration problems:

    fused_gather(query [B,N,3], ref [B,M,3], ref_mask [B,M] bool,
                 feats_t [B,F,M]) -> (d2 [B,N], gathered [B,F,N])

d2 is the exact masked minimum of |q|^2 + |r|^2 - 2 q.r (1e30 where a
problem has no valid target); ``gathered`` holds the features of the nearest
target, averaged over exact ties, zeros where there is none.

``fused_gather`` runs K1's plain twin, ``fused_gather_plain``: plain torch
with K1's semantics, the same distance arithmetic and tiles of 1024
targets. The reference launches no kernel.
"""

from __future__ import annotations

import torch

BIG = 1e30
TILE_M = 1024  # the TPU kernel's target tile (pallas_nn.TILE_M_GATHER)


def _check(query, ref, ref_mask, feats_t) -> tuple[int, int, int, int]:
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
    if feats_t.ndim != 3 or feats_t.shape[0] != B or feats_t.shape[2] != M:
        raise ValueError(f"feats_t must be [B={B}, F, M={M}], got {tuple(feats_t.shape)}")
    devices = {t.device for t in (query, ref, ref_mask, feats_t)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return B, N, M, feats_t.shape[1]


def fused_gather(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    feats_t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's plain twin on every device: the reference launches no kernel."""
    _check(query, ref, ref_mask, feats_t)
    return fused_gather_plain(query, ref, ref_mask, feats_t)


def fused_gather_plain(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    feats_t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K1, on any device.

    Follows ``_gather_kernel`` tile by tile (1024 targets): per tile the
    minimum, the features of every target equal to it summed by an equality
    matmul, and ties across tiles summed and counted; the sum is divided by
    max(count, 1) at the end. The distance uses the CUDA kernel's exact
    operation order (each product and sum rounded on its own), so the two
    agree bitwise on d2 and on which targets win.
    """
    best, g, cnt = _plain_scan(query, ref, ref_mask, feats_t)
    return best, g / torch.clamp_min(cnt, 1.0)[:, None]


def _plain_scan(query, ref, ref_mask, feats_t):
    """The twin's tile loop: (minimum d2, summed tie features, tie count:
    how many valid targets sit at the minimum, 0 where there is none)."""
    _check(query, ref, ref_mask, feats_t)
    B, N, _ = query.shape
    F = feats_t.shape[1]
    dt = query.dtype
    qx, qy, qz = (query[..., k, None] for k in range(3))  # [B, N, 1]
    qn = qx * qx + qy * qy + qz * qz
    best = torch.full((B, N), BIG, dtype=dt, device=query.device)
    g = torch.zeros((B, F, N), dtype=dt, device=query.device)
    cnt = torch.zeros((B, N), dtype=dt, device=query.device)
    for s in range(0, ref.shape[1], TILE_M):
        r = ref[:, s:s + TILE_M]
        m = ref_mask[:, None, s:s + TILE_M]  # [B, 1, TM]
        rx, ry, rz = (r[:, None, :, k] for k in range(3))  # [B, 1, TM]
        rn = rx * rx + ry * ry + rz * rz
        cross = qx * rx + qy * ry + qz * rz
        d2 = torch.where(m, (qn + rn) - 2.0 * cross, BIG)  # [B, N, TM]
        tmin = d2.amin(dim=-1)
        valid = tmin < 0.5 * BIG
        eq = ((d2 <= tmin[..., None]) & m & valid[..., None]).to(dt)
        gt = torch.bmm(feats_t[:, :, s:s + TILE_M].to(dt), eq.transpose(1, 2))
        ct = eq.sum(dim=-1)
        lt = tmin < best
        tie = (tmin == best) & valid
        g = torch.where(lt[:, None], gt, g + torch.where(tie[:, None], gt, 0.0))
        cnt = torch.where(lt, ct, cnt + torch.where(tie, ct, 0.0))
        best = torch.minimum(best, tmin)
    return best, g, cnt
