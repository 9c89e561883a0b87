"""Voxel grids with static shapes (port of ``rivslam_tpu/ops/voxel.py``):
the downsample, and the Gaussian voxel map of VGICP and NDT.

Points are quantised to integer voxel coords, sorted lexicographically by
one stable sort on a packed int64 key (the reference's three-key stable
``lax.sort``), and the runs of equal coords are reduced by a sorted-segment
sum. The segment sums use ``torch.segment_reduce``, which adds each
segment's values in order, one segment per thread: deterministic on the
card, where a float ``index_add_`` would change centroids from run to run.

``pack_voxel_coords`` packs in-range voxel coords into one order-preserving
int32 key, the key of VGICP's DIRECT neighbourhood match
(``frontend/vgicp.py``).
"""

from __future__ import annotations

import torch

from rivslam_tpu_torch.core.pointcloud import RadarCloud

_COORD_OFFSET = 1 << 20  # voxel coords assumed within +-2^20 (the reference's)
_KEY_BITS = 21
# the packed-key bound: coords in [-512, 512) pack into one int32 (10 bits an
# axis); out-of-range coords (the sentinel among them) saturate to the miss key
_PACK_BOUND = 512
_PACK_MISS = 2**31 - 1


def pack_voxel_coords(coords: torch.Tensor) -> torch.Tensor:
    """int32 voxel coords [..., 3] -> one order-preserving int32 key [...]:
    the lexicographic (x, y, z) order of in-range coords is the ascending
    order of their keys; out-of-range coords give ``_PACK_MISS``."""
    in_range = torch.all((coords >= -_PACK_BOUND) & (coords < _PACK_BOUND), dim=-1)
    off = coords + _PACK_BOUND
    key = (off[..., 0] << 20) | (off[..., 1] << 10) | off[..., 2]
    return torch.where(in_range, key, _PACK_MISS).to(torch.int32)


def _packed_keys(xyz: torch.Tensor, mask: torch.Tensor, resolution: float) -> torch.Tensor:
    """One int64 per point whose order is the lexicographic (kx, ky, kz)
    order of its voxel coords; invalid points sort last, as the reference's
    sentinel coords do. Coords are clamped to (-2^20, 2^20), which packs
    into 3 x 21 bits."""
    c = torch.floor(xyz / resolution)
    lim = float(_COORD_OFFSET - 1)
    c = (torch.clamp(torch.nan_to_num(c), -lim, lim) + _COORD_OFFSET).to(torch.int64)
    key = (c[..., 0] << (2 * _KEY_BITS)) | (c[..., 1] << _KEY_BITS) | c[..., 2]
    return torch.where(mask, key, torch.iinfo(torch.int64).max)


def voxel_downsample(cloud: RadarCloud, resolution: float, out_capacity: int) -> RadarCloud:
    """Centroid-per-voxel downsample, pcl::VoxelGrid semantics, for one
    cloud [N]. Output has capacity ``out_capacity``; voxels beyond it (in
    lexicographic coord order) are dropped, and the cloud comes back
    voxel-sorted."""
    keys = _packed_keys(cloud.xyz, cloud.mask, resolution)
    skeys, order = torch.sort(keys, stable=True)
    smask = cloud.mask[order]
    is_start = torch.ones_like(smask)
    is_start[1:] = skeys[1:] != skeys[:-1]
    is_start = is_start & smask
    seg_id = torch.cumsum(is_start.to(torch.int64), 0) - 1
    seg_id = torch.where(smask, seg_id, out_capacity)  # invalid -> dropped
    seg_id = torch.clamp_max(seg_id, out_capacity)  # overflow -> dropped bucket
    # seg_id never decreases along the sorted order, so segments are runs
    lengths = torch.bincount(seg_id, minlength=out_capacity + 1)

    def seg_sum(v):
        return torch.segment_reduce(v[order], "sum", lengths=lengths, unsafe=True)[:-1]

    dt = cloud.xyz.dtype
    cnt = seg_sum(cloud.mask.to(dt))
    safe = torch.clamp_min(cnt, 1.0)
    xyz = torch.stack([seg_sum(cloud.xyz[:, k]) for k in range(3)], dim=-1)
    return RadarCloud(
        xyz=xyz / safe[:, None],
        doppler=seg_sum(cloud.doppler) / safe,
        intensity=seg_sum(cloud.intensity) / safe,
        mask=cnt > 0,
    )


def gaussian_voxel_map(
    xyz: torch.Tensor, mask: torch.Tensor, resolution: float, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-voxel (mean, covariance, count): FastVGICP's additive voxel map
    (fast_vgicp_voxel.hpp:57-130) by one sort and segment sums, over a
    leading batch dim or none (xyz [..., N, 3], mask [..., N]).

    Returns (coords [..., V, 3] int32, means [..., V, 3], covs [..., V, 3, 3],
    counts [..., V]) with V = ``capacity``: occupied voxels first, in
    lexicographic coord order, as the reference's table; empty rows have
    coords -2^20, zero means, covariances and counts; voxels beyond the
    capacity are dropped."""
    if xyz.ndim == 2:
        return tuple(t[0] for t in gaussian_voxel_map(xyz[None], mask[None], resolution, capacity))
    B = xyz.shape[0]
    dt = xyz.dtype
    keys = _packed_keys(xyz, mask, resolution)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    p = torch.take_along_dim(xyz, order[..., None], dim=1)  # [B, N, 3] sorted
    smask = torch.take_along_dim(mask, order, dim=1)
    is_start = torch.ones_like(smask)
    is_start[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    is_start = is_start & smask
    seg_id = torch.cumsum(is_start.to(torch.int64), 1) - 1
    seg_id = torch.clamp_max(torch.where(smask, seg_id, capacity), capacity)  # invalid, overflow: dropped
    # row-major segment ids never decrease along the flattened sorted order
    flat = (seg_id + torch.arange(B, device=xyz.device)[:, None] * (capacity + 1)).reshape(-1)
    lengths = torch.bincount(flat, minlength=B * (capacity + 1))

    def seg_sum(v):  # [B, N, ...] in sorted order -> [B, V, ...]
        out = torch.segment_reduce(v.reshape((-1,) + v.shape[2:]), "sum", lengths=lengths, unsafe=True)
        return out.reshape((B, capacity + 1) + v.shape[2:])[:, :-1]

    m = smask.to(dt)
    cnt = seg_sum(m)
    safe = torch.clamp_min(cnt, 1.0)
    mean = seg_sum(p) / safe[..., None]
    outer = p[..., :, None] * p[..., None, :] * m[..., None, None]
    cov = seg_sum(outer) / safe[..., None, None] - mean[..., :, None] * mean[..., None, :]
    # each voxel's integer coords, from its first point
    c = torch.floor(p / resolution).to(torch.int32)
    coords = torch.full((B, capacity + 1, 3), -_COORD_OFFSET, dtype=torch.int32, device=xyz.device)
    first = torch.where(is_start, seg_id, capacity)  # the rest land in the dropped row
    coords.scatter_(1, first[..., None].expand(-1, -1, 3), c)
    return coords[:, :-1], mean, cov, cnt
