"""VGICP registration of a frame pair as plain float64 math, written from
the method as fast_gicp's ``FastVGICP`` computes it (the registration that
RIV-SLAM's ``registrations.cpp`` builds for FAST_VGICP), not from the
program's code.

The target's voxel map, fast_gicp's default ``AdditiveGaussianVoxel``
(fast_vgicp_voxel.hpp; Koide et al., "Voxelized GICP for Fast and Accurate
3D Point Cloud Registration", ICRA 2021, Sec. III): each valid target point
b_j with its covariance C^B_j falls in the voxel floor(b_j / r) of
resolution r; a voxel v of N_v points has

    mu_v = sum_{j in v} b_j / N_v,    C_v = sum_{j in v} C^B_j / N_v

(``append`` adds the point and its covariance, ``finalize`` divides both
by the count). The point covariances are already regularized; the voxel
is not regularized again.

The error at a transform T = (R, t), source to target, with DIRECT1
correspondences (each transformed source point p_i = R a_i + t against the
voxel that holds it, if there is one):

    E(T) = sum_i w_v d_i^T (C_v + R C^A_i R^T)^-1 d_i,   d_i = mu_v - p_i,
    w_v = sqrt(N_v).

The weight is fast_gicp's: ``FastVGICP::linearize`` and ``compute_error``
take ``w = sqrt(num_points)`` on each term of H, b and the error; the
paper's objective weights by N_v. A registration has converged where one
Gauss-Newton step from its answer, with its correspondences and their
(C_v + R C^A R^T)^-1 held at the answer, is under the configuration's
stopping rule; ``step_units`` gives that step in units of the rule, as
``reference/gicp.py`` does for GICP.

Voxels are grouped with ``torch.unique`` over (problem, voxel coords) rows,
a plain grouping; everything is batched over a leading dimension of B
problems. ``register`` is a plain Gauss-Newton loop, the control's
registration in the program's place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.gicp import F64, hat, so3_exp

# matrix products of the reference are exact float64 products; TF32 would
# round them to 10 bits of mantissa in float32 (the control's precision)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class VoxelMap:
    """The voxels of B problems: rows (problem, voxel coords) [V, 4] int64,
    means [V, 3], covariances [V, 3, 3], point counts [V]."""

    keys: torch.Tensor
    mean: torch.Tensor
    cov: torch.Tensor
    count: torch.Tensor


def _keys(xyz: torch.Tensor, resolution: float) -> torch.Tensor:
    """[B, N, 3] -> (problem, floor(xyz / r)) rows [B, N, 4]."""
    B, N = xyz.shape[:2]
    b = torch.arange(B, device=xyz.device)[:, None, None].expand(B, N, 1)
    return torch.cat([b, torch.floor(xyz / resolution).to(torch.int64)], dim=-1)


def build_map(xyz: torch.Tensor, mask: torch.Tensor, cov: torch.Tensor, resolution: float,
              dtype=F64) -> VoxelMap:
    """The additive voxel map of B target clouds: xyz [B, N, 3], mask
    [B, N], the points' covariances [B, N, 3, 3], in ``dtype``."""
    x, c = xyz.to(dtype), cov.to(dtype)
    m = mask.bool()
    keys = _keys(x, resolution)[m]
    uniq, inv = torch.unique(keys, dim=0, return_inverse=True)
    V = uniq.shape[0]
    count = torch.zeros(V, dtype=dtype, device=x.device).index_add_(0, inv, torch.ones_like(inv, dtype=dtype))
    mean = torch.zeros((V, 3), dtype=dtype, device=x.device).index_add_(0, inv, x[m]) / count[:, None]
    vcov = torch.zeros((V, 3, 3), dtype=dtype, device=x.device).index_add_(0, inv, c[m]) / count[:, None, None]
    return VoxelMap(keys=uniq, mean=mean, cov=vcov, count=count)


def lookup(vm: VoxelMap, keys: torch.Tensor) -> torch.Tensor:
    """The row of ``vm`` of each (problem, voxel coords) row of ``keys``
    [..., 4], or -1 where no voxel has it."""
    flat = keys.reshape(-1, 4)
    V = vm.keys.shape[0]
    uniq, inv = torch.unique(torch.cat([vm.keys, flat]), dim=0, return_inverse=True)
    slot = torch.full((uniq.shape[0],), -1, dtype=torch.int64, device=flat.device)
    slot[inv[:V]] = torch.arange(V, device=flat.device)
    return slot[inv[V:]].reshape(keys.shape[:-1])


class Problem:
    """One batch of VGICP registrations in ``dtype`` (float64 unless the
    control asks for its own): source xyz/mask/cov [B, N, ...], the target's
    voxel map, the registration configuration (voxel resolution and
    stopping rule)."""

    def __init__(self, src_xyz, src_mask, src_cov, tgt_xyz, tgt_mask, tgt_cov, cfg, dtype=F64):
        self.dtype = dtype
        self.s, self.sm, self.sc = src_xyz.to(dtype), src_mask.bool(), src_cov.to(dtype)
        self.cfg = cfg
        self.map = build_map(tgt_xyz, tgt_mask, tgt_cov, cfg.voxel_resolution, dtype)

    def terms(self, T: torch.Tensor):
        """At T [B, 4, 4]: the transformed points p [B, N, 3], the residuals
        d = mu_v - p, and the weighted information sqrt(N_v) (C_v + R C^A
        R^T)^-1 of each DIRECT1 correspondence, zero where a point has none
        [B, N, 3, 3]."""
        T = T.to(self.dtype)
        R, t = T[:, :3, :3], T[:, :3, 3]
        p = torch.einsum("bij,bnj->bni", R, self.s) + t[:, None, :]
        row = lookup(self.map, _keys(p, self.cfg.voxel_resolution))
        ok = self.sm & (row >= 0)
        r = row.clamp_min(0)
        mu, cv, n = self.map.mean[r], self.map.cov[r], self.map.count[r]
        C = cv + torch.einsum("bij,bnjk,blk->bnil", R, self.sc, R)
        eye = torch.eye(3, dtype=self.dtype, device=p.device)
        C = torch.where(ok[..., None, None], C, eye)
        info = torch.linalg.inv(C) * (torch.sqrt(n) * ok)[..., None, None]
        return p, mu - p, info

    def error(self, T: torch.Tensor) -> torch.Tensor:
        """E(T) [B]."""
        _, e, info = self.terms(T)
        return torch.einsum("bni,bnij,bnj->b", e, info, e)

    def normal_equations(self, T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """H [B, 6, 6] and b [B, 6] of the Gauss-Newton step from T, over
        (rotation w, translation u) applied as [exp(w) | u] @ T, with the
        correspondences and the information held at T."""
        p, e, info = self.terms(T)
        eye = torch.eye(3, dtype=self.dtype, device=p.device).expand_as(info)
        J = torch.cat([hat(p), -eye], dim=-1)  # d e / d(w, u): [B, N, 3, 6]
        H = torch.einsum("bnki,bnkl,bnlj->bij", J, info, J)
        b = torch.einsum("bnki,bnkl,bnl->bi", J, info, e)
        return H, b

    def gn_step(self, T: torch.Tensor) -> torch.Tensor:
        """The Gauss-Newton step [B, 6] = (w, u) from T: -H^-1 b."""
        H, b = self.normal_equations(T)
        return -torch.linalg.solve_ex(H, b)[0]

    def step_units(self, T: torch.Tensor) -> torch.Tensor:
        """The GN step from T in units of the stopping rule [B]: the larger
        of its largest |exp(w) - I| entry over ``rotation_epsilon`` and its
        largest |u| entry over ``transformation_epsilon``."""
        d = self.gn_step(T)
        return _units(d, self.cfg)

    def register(self, T0: torch.Tensor, max_iterations: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Gauss-Newton from T0 [B, 4, 4] until every problem's step is
        under the stopping rule (or ``max_iterations``, the configuration's
        by default): (T [B, 4, 4], E(T) [B])."""
        T = T0.to(self.dtype).clone()
        done = torch.zeros(T.shape[0], dtype=torch.bool, device=T.device)
        for _ in range(max_iterations or self.cfg.max_iterations):
            d = self.gn_step(T)
            step = torch.eye(4, dtype=self.dtype, device=T.device).repeat(T.shape[0], 1, 1)
            step[:, :3, :3] = so3_exp(d[:, :3])
            step[:, :3, 3] = d[:, 3:]
            T = torch.where(done[:, None, None], T, step @ T)
            done = done | (_units(d, self.cfg) < 1.0)
            if bool(done.all()):
                break
        return T, self.error(T)


def _units(d: torch.Tensor, cfg) -> torch.Tensor:
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    rot = torch.amax(torch.abs(so3_exp(d[:, :3]) - eye), dim=(-2, -1)) / cfg.rotation_epsilon
    trans = torch.amax(torch.abs(d[:, 3:]), dim=-1) / cfg.transformation_epsilon
    return torch.nan_to_num(torch.maximum(rot, trans), nan=math.inf).to(F64)


def map_gaps(coords: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor, count: torch.Tensor,
             ref: VoxelMap, resolution: float) -> torch.Tensor:
    """Each voxel of a program's map of B problems (coords [B, V, 3], means,
    covariances and counts [B, V, ...], empty rows with count 0) against
    the reference's map of the same clouds: the larger of its mean's
    distance over the resolution and its covariance's relative Frobenius
    distance; inf for a voxel whose count differs, or that the other map
    lacks. Returns [the voxels of both maps]."""
    B = coords.shape[0]
    valid = count > 0
    b = torch.arange(B, device=coords.device)[:, None, None].expand(B, coords.shape[1], 1)
    keys = torch.cat([b, coords.to(torch.int64)], dim=-1)[valid]
    row = lookup(ref, keys)
    hit = row >= 0
    r = row.clamp_min(0)
    dm = torch.linalg.norm(mean[valid].to(F64) - ref.mean[r].to(F64), dim=-1) / resolution
    want = ref.cov[r].to(F64)
    dc = torch.linalg.norm(cov[valid].to(F64) - want, dim=(-2, -1)) / torch.linalg.norm(want, dim=(-2, -1)).clamp_min(
        1e-300)
    same = hit & (count[valid].to(F64) == ref.count[r].to(F64))
    gaps = torch.where(same, torch.maximum(dm, dc), torch.full_like(dm, math.inf))
    # reference voxels that the program's map lacks
    missing = ref.keys.shape[0] - int(hit.sum())
    return torch.cat([gaps, torch.full((max(missing, 0),), math.inf, dtype=F64, device=gaps.device)])


def blocks(n: int, size: int):
    """Slices of ``size`` rows covering ``n``."""
    return [slice(s, min(s + size, n)) for s in range(0, n, size)]
