"""Voxelized GICP (VGICP) and NDT: registration against a Gaussian voxel map
(port of ``rivslam_tpu/frontend/vgicp.py``).

Capability parity with FastVGICP / FastVGICPCuda and NDTCuda (fast_vgicp.hpp
and impl, fast_vgicp_voxel.hpp:57-130, ndt/ndt_cuda.hpp): the target becomes
a map of per-voxel (mean, covariance, count) in additive mode, built by one
sort and segment sums (``ops/voxel.gaussian_voxel_map``); each source point
is matched to nearby voxels and contributes a point-to-distribution
Mahalanobis term.

Neighbourhoods (``cfg.vgicp_neighborhood``, ``cfg.ndt_neighborhood``):
- DIRECT1 / DIRECT7, the reference's voxel-hash lookup of the point's voxel
  (and its 6 face neighbours), as the reference's packed-key match: voxel
  coords pack into one order-preserving int32 key, a face neighbour's key is
  the centre key plus a constant, so one [N, V] int difference matrix
  answers every neighbourhood and each neighbour's (mean, covariance) is a
  one-hot matmul against the [V, 13] payload;
- KDTREE, the nearest 7 voxel centres by an [N, V] distance matrix and a
  stable top-k.

Everything is batched over a leading problem dim B. The LM driver is
``apdgicp``'s: each method is a model for ``apdgicp.run_registration``
(``MODELS``), so ``apdgicp.GraphedRegistration`` replays it as CUDA graphs
on the card, as it does the GICP family. The voxel map is built once per
registration, outside the graphs. The reference's VGICP/NDT driver runs LM
whatever ``cfg.optimizer`` says; so does this one.
"""

from __future__ import annotations

import dataclasses

import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp
from rivslam_tpu_torch.ops import voxel as voxel_mod


@dataclasses.dataclass(frozen=True)
class VoxelMap:
    coords: torch.Tensor  # [B, V, 3] int32 voxel coords
    mean: torch.Tensor  # [B, V, 3]
    cov: torch.Tensor  # [B, V, 3, 3] regularized
    count: torch.Tensor  # [B, V]

    @property
    def valid(self) -> torch.Tensor:
        return self.count > 0


def build_voxel_map(xyz: torch.Tensor, mask: torch.Tensor, cfg: RegistrationConfig,
                    capacity: int = 2048) -> VoxelMap:
    """The Gaussian voxel map of a cloud ([B, N] or [N]), its covariances
    regularized as the point covariances (eigenvalues clamped at 1e-3)."""
    coords, mean, cov, cnt = voxel_mod.gaussian_voxel_map(
        torch.where(mask[..., None], xyz, 1e6), mask, cfg.voxel_resolution, capacity
    )
    vals, vecs = torch.linalg.eigh(cov + 1e-9 * torch.eye(3, dtype=xyz.dtype, device=xyz.device))
    new_vals = torch.clamp_min(vals, 1e-3)
    cov_reg = torch.einsum("...ij,...j,...kj->...ik", vecs, new_vals, vecs)
    return VoxelMap(coords=coords, mean=mean, cov=cov_reg, count=cnt)


# the DIRECT7 neighbourhood: the point's own voxel and its 6 face neighbours
# (fast_vgicp_voxel.hpp neighbor_offsets), as packed-key deltas
_DIRECT_DELTAS = (0, 1 << 20, -(1 << 20), 1 << 10, -(1 << 10), 1, -1)


def _mahalanobis_from(cov_B, cov_A_rot, corr):
    mah = apdgicp._inv3(cov_B + cov_A_rot[:, :, None])
    return torch.where(corr[..., None, None], mah, 0.0)


def _rotated_src_cov(T, src_cov):
    R = T[:, None, :3, :3]
    return R @ src_cov @ R.transpose(-1, -2)  # [B, N, 3, 3]


def _voxel_correspondences_nearest(T, src_xyz, src_mask, src_cov, vm: VoxelMap, cfg, k_neighbors=7):
    """The nearest voxel centres (the KDTREE search option,
    registrations.cpp:126): [N, V] distances, the k smallest with ties to
    the lower index (the reference's ``lax.top_k``)."""
    pt = lie.transform_points(T, src_xyz)
    centers = (vm.coords.to(pt.dtype) + 0.5) * cfg.voxel_resolution
    centers = torch.where(vm.valid[..., None], centers, 1e6)
    d2 = (torch.sum(pt * pt, dim=-1)[..., :, None] + torch.sum(centers * centers, dim=-1)[..., None, :]
          - 2.0 * pt @ centers.transpose(-1, -2))
    neg, idx = torch.sort(-d2, dim=-1, descending=True, stable=True)
    neg, idx = neg[..., :k_neighbors], idx[..., :k_neighbors]  # [B, N, k]
    # a voxel takes part if its centre is within one voxel diagonal
    radius = cfg.voxel_resolution * 0.87 * 2.0
    B, N = idx.shape[:2]
    flat = idx.reshape(B, -1)
    count = torch.take_along_dim(vm.count, flat, dim=1).reshape(B, N, -1)
    corr = (-neg < radius * radius) & src_mask[..., None] & (count > 0)
    mean_B = torch.take_along_dim(vm.mean, flat[..., None], dim=1).reshape(B, N, -1, 3)
    cov_B = torch.take_along_dim(vm.cov, flat[..., None, None], dim=1).reshape(B, N, -1, 3, 3)
    return mean_B, corr, _mahalanobis_from(cov_B, _rotated_src_cov(T, src_cov), corr)


def _voxel_correspondences_direct(T, src_xyz, src_mask, src_cov, vm: VoxelMap, cfg, n_offsets: int):
    """DIRECT7 / DIRECT1 (fast_vgicp_voxel.hpp:57-130,
    find_voxel_correspondences.cu:114) as the reference's packed-key match:
    ``diff == delta_k`` of the [N, V] matrix ``table - key`` is the exact
    one-hot of neighbour k, and its matmul against the [V, 13] payload
    (mean, covariance, validity) gathers that voxel. Points within one cell
    of the packing bound (+-511 voxels) get no correspondence, so every
    neighbour delta is carry-free."""
    pt = lie.transform_points(T, src_xyz)
    dtype = pt.dtype
    B, V = vm.coords.shape[:2]
    table = voxel_mod.pack_voxel_coords(
        torch.where(vm.valid[..., None], vm.coords, voxel_mod._COORD_OFFSET)
    )  # [B, V]; empty rows pack to the miss key
    c = torch.floor(pt / cfg.voxel_resolution).to(torch.int32)
    bound = voxel_mod._PACK_BOUND
    in_rng = torch.all((c >= -(bound - 1)) & (c <= bound - 2), dim=-1)
    miss = voxel_mod._PACK_MISS
    qk0 = torch.where(in_rng & src_mask, voxel_mod.pack_voxel_coords(c), miss)  # [B, N]
    diff = table[:, None, :] - qk0[:, :, None]  # [B, N, V] int32
    payload = torch.cat([vm.mean, vm.cov.reshape(B, V, 9), torch.ones((B, V, 1), dtype=dtype, device=pt.device)],
                        dim=-1)
    payload = torch.where(vm.valid[..., None], payload, 0.0)  # [B, V, 13]
    gathered = torch.stack([(diff == d).to(dtype) @ payload for d in _DIRECT_DELTAS[:n_offsets]], dim=2)
    corr = (gathered[..., 12] > 0.5) & (qk0 != miss)[..., None]  # [B, N, k]
    mean_B = gathered[..., :3]
    cov_B = gathered[..., 3:12].reshape(B, pt.shape[1], n_offsets, 3, 3)
    return mean_B, corr, _mahalanobis_from(cov_B, _rotated_src_cov(T, src_cov), corr)


def _voxel_correspondences(T, src_xyz, src_mask, src_cov, vm: VoxelMap, cfg, method: str):
    """The neighbourhood dispatch (fast_vgicp.hpp:74, registrations.cpp:117-131)."""
    if method == "DIRECT7":
        return _voxel_correspondences_direct(T, src_xyz, src_mask, src_cov, vm, cfg, 7)
    if method == "DIRECT1":
        return _voxel_correspondences_direct(T, src_xyz, src_mask, src_cov, vm, cfg, 1)
    if method == "KDTREE":
        return _voxel_correspondences_nearest(T, src_xyz, src_mask, src_cov, vm, cfg)
    raise ValueError(f"unknown voxel neighborhood {method!r}")


def _linearize_vgicp(T, src_xyz, mean_B, corr, mah):
    """H, b, error over the fixed voxel correspondences."""
    pt = lie.transform_points(T, src_xyz)  # [B, N, 3]
    e = mean_B - pt[:, :, None, :]  # [B, N, k, 3]
    me = torch.einsum("bnkij,bnkj->bnki", mah, e)
    err = torch.sum(torch.where(corr, torch.sum(e * me, dim=-1), 0.0), dim=(1, 2))
    neg_eye = -torch.eye(3, dtype=pt.dtype, device=pt.device).expand(pt.shape + (3,))
    J = torch.cat([lie.hat(pt), neg_eye], dim=-1)  # [B, N, 3, 6]
    MJ = torch.einsum("bnkij,bnjl->bnkil", mah, J)
    H = torch.einsum("bnji,bnkjl->bil", J, MJ)
    b = torch.einsum("bnji,bnkj->bi", J, me)
    return H, b, err


def _error_vgicp(T, src_xyz, mean_B, corr, mah):
    e = mean_B - lie.transform_points(T, src_xyz)[:, :, None, :]
    quad = torch.einsum("bnkij,bnki,bnkj->bnk", mah, e, e)
    return torch.sum(torch.where(corr, quad, 0.0), dim=(1, 2))


def _make_model(neighborhood: str):
    def model(src_xyz, src_mask, src_cov, coords, mean, cov, count, cfg: RegistrationConfig):
        """``apdgicp.run_registration``'s functions for VGICP / NDT over the
        source and the target's voxel map."""
        vm = VoxelMap(coords=coords, mean=mean, cov=cov, count=count)

        def correspondences(T):
            return _voxel_correspondences(T, src_xyz, src_mask, src_cov, vm, cfg, neighborhood)

        def linearize_at(T):
            mean_B, corr, mah = c = correspondences(T)
            return (*_linearize_vgicp(T, src_xyz, mean_B, corr, mah), c)

        def error_at(T, c):
            return _error_vgicp(T, src_xyz, *c)

        def final_at(T):
            mean_B, corr, mah = correspondences(T)
            ncorr = torch.sum(corr, dim=(1, 2))
            pt = lie.transform_points(T, src_xyz)
            d2 = torch.sum((mean_B - pt[:, :, None, :]) ** 2, dim=-1)
            fitness = torch.sum(torch.where(corr, d2, 0.0), dim=(1, 2)) / torch.clamp_min(ncorr, 1)
            _, _, final_err = _linearize_vgicp(T, src_xyz, mean_B, corr, mah)
            return final_err, ncorr.to(torch.int32), fitness

        return linearize_at, error_at, final_at

    model.__name__ = model.__qualname__ = f"voxel_model_{neighborhood}"
    return model


# one model per neighbourhood: the model is part of a registration graph's key
MODELS = {nb: _make_model(nb) for nb in ("DIRECT1", "DIRECT7", "KDTREE")}


def register_vgicp(src: apdgicp.PreparedCloud, vm: VoxelMap, guess: torch.Tensor, cfg: RegistrationConfig,
                   neighborhood: str | None = None,
                   graphs: apdgicp.GraphedRegistration | None = None) -> apdgicp.RegistrationResult:
    """LsqRegistration's LM over voxel correspondences, B problems: src
    fields [B, N, ...], the voxel map [B, V, ...], guess [B, 4, 4];
    ``graphs`` as in ``apdgicp.run_registration``."""
    nb = neighborhood or cfg.vgicp_neighborhood
    if nb not in MODELS:
        raise ValueError(f"unknown voxel neighborhood {nb!r}")
    if cfg.optimizer != "LM":
        cfg = dataclasses.replace(cfg, optimizer="LM")
    problem = (src.xyz.contiguous(), src.mask.contiguous(), src.cov.contiguous(), vm.coords.contiguous(),
               vm.mean.contiguous(), vm.cov.contiguous(), vm.count.contiguous())
    return apdgicp.run_registration(MODELS[nb], problem, guess.to(src.xyz.dtype), cfg, graphs)


def register_ndt(src_xyz: torch.Tensor, src_mask: torch.Tensor, vm: VoxelMap, guess: torch.Tensor,
                 cfg: RegistrationConfig, mode: str = "P2D", src_capacity: int = 2048,
                 graphs: apdgicp.GraphedRegistration | None = None) -> apdgicp.RegistrationResult:
    """NDT through Gaussian voxels (fast_gicp's NDTCuda: Mahalanobis
    distances of the per-voxel normal distributions, no exponential score),
    over ``cfg.ndt_neighborhood``:
    - P2D: each source point against the target's voxel distributions
      (source covariance 0);
    - D2D: each source voxel distribution against the target's."""
    if mode == "P2D":
        src = apdgicp.PreparedCloud(xyz=src_xyz, mask=src_mask,
                                    cov=torch.zeros(src_xyz.shape[:-1] + (3, 3), dtype=src_xyz.dtype,
                                                    device=src_xyz.device))
    elif mode == "D2D":
        svm = build_voxel_map(src_xyz, src_mask, cfg, capacity=src_capacity)
        src = apdgicp.PreparedCloud(xyz=svm.mean, mask=svm.valid, cov=svm.cov)
    else:
        raise ValueError(mode)
    return register_vgicp(src, vm, guess, cfg, neighborhood=cfg.ndt_neighborhood, graphs=graphs)
