"""The registration of a frame pair as plain float64 math, written from the
method (generalized ICP with RBF-kernel covariances and the APD-GICP
distance-dependent noise of 4DRadarSLAM), not from the program's code.

Given a source cloud and a target cloud, each with per-point covariances,
and a transform T (source to target), each valid source point p = R s + t
is matched to its nearest valid target point g within the correspondence
limit, and the error is

    E(T) = sum_i (g_i - p_i)^T C_i^-1 (g_i - p_i),
    C_i = C_g + D(p_i) + R (C_s + D(p_i)) R^T,

with D the APD noise at the transformed point (FAST_APDGICP; zero for the
plain GICP methods). A registration has converged where one Gauss-Newton
step from its answer, with its correspondences and C held at the answer,
is under the configuration's stopping rule (the step's largest rotation
entry under ``rotation_epsilon``, its largest translation under
``transformation_epsilon``); ``step_units`` gives that step in units of
the rule.

Everything is batched over a leading dimension of B problems.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrix [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v.unbind(-1)
    return torch.stack([torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, [..., 3] -> [..., 3, 3], with the series near 0."""
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-16
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def rbf_covariances(xyz: torch.Tensor, mask: torch.Tensor, width: float, max_dist: float) -> torch.Tensor:
    """Each point's covariance of its neighbours within ``max_dist``
    (itself included), weighted by exp(-width d^2) and centred on their
    weighted mean, then PLANE-regularized: the smallest eigenvalue's axis
    v kept and the covariance replaced by I - (1 - 1e-3) v v^T.
    xyz [B, N, 3], mask [B, N] -> [B, N, 3, 3] (invalid points too)."""
    x = xyz.to(F64)
    d2 = torch.cdist(x, x).square()
    w = torch.exp(-width * d2) * ((d2 <= max_dist * max_dist) & mask[:, None, :] & mask[:, :, None])
    sw = torch.clamp_min(w.sum(-1), 1e-300)[..., None]
    mean = (w @ x) / sw
    outer = (x[..., :, None] * x[..., None, :]).flatten(-2)  # [B, M, 9]
    exx = ((w @ outer) / sw).unflatten(-1, (3, 3))
    cov = exx - mean[..., :, None] * mean[..., None, :]
    # on the host: cuSOLVER's batched eigh refuses a batch of B x N matrices
    # at these sizes (CUSOLVER_STATUS_INVALID_VALUE on an H100)
    _, vecs = torch.linalg.eigh(cov.cpu())
    v = vecs[..., :, 0].to(x.device)
    eye = torch.eye(3, dtype=F64, device=x.device)
    return eye - (1.0 - 1e-3) * v[..., :, None] * v[..., None, :]


def apd_noise(p: torch.Tensor, cfg) -> torch.Tensor:
    """The APD-GICP noise at points p [..., 3]: along the range
    (dist_var / 400 of the range), across it in azimuth and elevation
    (sin of the angle's variance times the range, over the cosine of the
    angle between p and the x axis), as sigma^2 on the spherical axes."""
    dist = torch.linalg.norm(p, dim=-1).clamp_min(1e-6)
    rxy = torch.linalg.norm(p[..., :2], dim=-1).clamp_min(1e-12)
    rho = torch.linalg.norm(p[..., 1:], dim=-1).clamp_min(1e-12)
    cos_aoa = (rho / dist).clamp_min(1e-6)
    sig = torch.stack([dist * cfg.dist_var / 400.0,
                       dist * math.sin(math.radians(cfg.azimuth_var)) / cos_aoa,
                       dist * math.sin(math.radians(cfg.elevation_var)) / cos_aoa], -1)
    ca, sa = p[..., 0] / rxy, p[..., 1] / rxy
    se, ce = rxy / dist, p[..., 2] / dist
    axes = torch.stack([torch.stack([ce * ca, ce * sa, -se], -1),
                        torch.stack([-sa, ca, torch.zeros_like(sa)], -1),
                        torch.stack([se * ca, se * sa, ce], -1)], -2)  # [..., 3 axes, 3]
    return torch.einsum("...k,...ki,...kj->...ij", sig * sig, axes, axes)


class Problem:
    """One batch of registrations in float64: source xyz/mask/cov, target
    xyz/mask/cov ([B, N, ...] and [B, M, ...]) and the registration
    configuration (its method, correspondence limit and stopping rule)."""

    def __init__(self, src_xyz, src_mask, src_cov, tgt_xyz, tgt_mask, tgt_cov, cfg):
        self.s, self.sm, self.sc = src_xyz.to(F64), src_mask.bool(), src_cov.to(F64)
        self.t, self.tm, self.tc = tgt_xyz.to(F64), tgt_mask.bool(), tgt_cov.to(F64)
        self.cfg = cfg
        self.apd = cfg.method == "FAST_APDGICP"

    def terms(self, T: torch.Tensor):
        """At T [B, 4, 4]: the transformed points p [B, N, 3], the residuals
        e = g - p, the information C^-1 times the match flag [B, N, 3, 3]."""
        T = T.to(F64)
        R, t = T[:, :3, :3], T[:, :3, 3]
        p = torch.einsum("bij,bnj->bni", R, self.s) + t[:, None, :]
        d2 = torch.cdist(p, self.t).square().masked_fill(~self.tm[:, None, :], math.inf)
        best, idx = d2.min(-1)
        ok = self.sm & (best < self.cfg.max_correspondence_distance ** 2)
        g = torch.take_along_dim(self.t, idx[..., None], dim=1)
        cg = torch.take_along_dim(self.tc, idx[..., None, None], dim=1)
        C = cg + torch.einsum("bij,bnjk,blk->bnil", R, self.sc, R)
        if self.apd:
            D = apd_noise(p, self.cfg)
            C = C + D + torch.einsum("bij,bnjk,blk->bnil", R, D, R)
        eye = torch.eye(3, dtype=F64, device=p.device)
        C = torch.where(ok[..., None, None], C, eye)
        info = torch.linalg.inv(C) * ok[..., None, None]
        return p, g - p, info

    def error(self, T: torch.Tensor) -> torch.Tensor:
        """E(T) [B]."""
        _, e, info = self.terms(T)
        return torch.einsum("bni,bnij,bnj->b", e, info, e)

    def gn_step(self, T: torch.Tensor) -> torch.Tensor:
        """The Gauss-Newton step [B, 6] = (rotation w, translation u) from T,
        applied as [exp(w) | u] @ T, with the correspondences and C at T."""
        p, e, info = self.terms(T)
        eye = torch.eye(3, dtype=F64, device=p.device).expand_as(info)
        J = torch.cat([hat(p), -eye], dim=-1)  # d e / d(w, u): [B, N, 3, 6]
        H = torch.einsum("bnki,bnkl,bnlj->bij", J, info, J)
        b = torch.einsum("bnki,bnkl,bnl->bi", J, info, e)
        return -torch.linalg.solve_ex(H, b)[0]

    def step_units(self, T: torch.Tensor) -> torch.Tensor:
        """The GN step from T in units of the stopping rule [B]: the larger
        of its largest |exp(w) - I| entry over ``rotation_epsilon`` and its
        largest |u| entry over ``transformation_epsilon``."""
        d = self.gn_step(T)
        eye = torch.eye(3, dtype=F64, device=d.device)
        rot = torch.amax(torch.abs(so3_exp(d[:, :3]) - eye), dim=(-2, -1)) / self.cfg.rotation_epsilon
        trans = torch.amax(torch.abs(d[:, 3:]), dim=-1) / self.cfg.transformation_epsilon
        return torch.nan_to_num(torch.maximum(rot, trans), nan=math.inf)


def blocks(n: int, size: int):
    """Slices of ``size`` rows covering ``n``."""
    return [slice(s, min(s + size, n)) for s in range(0, n, size)]
