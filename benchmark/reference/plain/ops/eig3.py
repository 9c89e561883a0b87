"""Closed-form symmetric 3x3 eigen-analysis (port of ``rivslam_tpu/ops/eig3.py``).

GICP's PLANE regularization only needs the SMALLEST eigenvector v:
    U diag(1, 1, eps) U^T  ==  I - (1 - eps) v v^T
Eigenvalues come from Cardano's trigonometric formula and v from the
best-conditioned cross product of rows of (A - lambda_min I). Every input is
a component tensor of any shape (structure-of-arrays), all of one shape.
Degenerate spectra fall back to a fixed axis, as in the reference. The
[..., 3, 3] forms at the end serve the floor detector's normal filter.
"""

from __future__ import annotations

import math

import torch


def smallest_eigenvalue_soa(a00, a01, a02, a11, a12, a22):
    """Smallest eigenvalue from the 6 unique components (Cardano)."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    small = p2 < 1e-24
    p_safe = torch.sqrt(torch.where(small, 1.0, p2) / 6.0)
    inv_p = torch.where(small, 0.0, 1.0 / p_safe)
    p = torch.where(small, 0.0, p_safe)
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) * (inv_p**3)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    return q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)


def smallest_eigenvector_soa(a00, a01, a02, a11, a12, a22):
    """Unit smallest-eigenvector components from symmetric components."""
    lam = smallest_eigenvalue_soa(a00, a01, a02, a11, a12, a22)
    b00, b11, b22 = a00 - lam, a11 - lam, a22 - lam
    # rows of B: r0=(b00,a01,a02), r1=(a01,b11,a12), r2=(a02,a12,b22)
    c0x = a01 * a12 - a02 * b11
    c0y = a02 * a01 - b00 * a12
    c0z = b00 * b11 - a01 * a01
    c1x = b11 * b22 - a12 * a12
    c1y = a12 * a02 - a01 * b22
    c1z = a01 * a12 - b11 * a02
    c2x = a12 * a02 - b22 * a01
    c2y = b22 * b00 - a02 * a02
    c2z = a02 * a01 - a12 * b00
    n0 = c0x * c0x + c0y * c0y + c0z * c0z
    n1 = c1x * c1x + c1y * c1y + c1z * c1z
    n2 = c2x * c2x + c2y * c2y + c2z * c2z
    use1 = (n1 >= n0) & (n1 >= n2)
    use2 = (n2 > n0) & ~use1
    vx = torch.where(use1, c1x, torch.where(use2, c2x, c0x))
    vy = torch.where(use1, c1y, torch.where(use2, c2y, c0y))
    vz = torch.where(use1, c1z, torch.where(use2, c2z, c0z))
    nbest = torch.where(use1, n1, torch.where(use2, n2, n0))
    ok = nbest > 1e-20
    vx = torch.where(ok, vx, 0.0)
    vy = torch.where(ok, vy, 0.0)
    vz = torch.where(ok, vz, 1.0)
    inv = 1.0 / torch.sqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz, 1e-20))
    return vx * inv, vy * inv, vz * inv


def plane_regularize_soa(a00, a01, a02, a11, a12, a22, eps: float = 1e-3):
    """PLANE regularization in component form:
    I - (1-eps) v v^T with v the smallest eigenvector."""
    vx, vy, vz = smallest_eigenvector_soa(a00, a01, a02, a11, a12, a22)
    s = 1.0 - eps
    one = torch.ones_like(a00)
    return (
        one - s * vx * vx,
        -s * vx * vy,
        -s * vx * vz,
        one - s * vy * vy,
        -s * vy * vz,
        one - s * vz * vz,
    )


def eigenvalues_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending (Cardano/trig form)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    small = p2 < 1e-24
    p_safe = torch.sqrt(torch.where(small, 1.0, p2) / 6.0)
    inv_p = torch.where(small, 0.0, 1.0 / p_safe)
    p = torch.where(small, 0.0, p_safe)
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) * (inv_p**3)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)  # largest
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    l2 = 3.0 * q - l1 - l3
    return torch.stack([l3, l2, l1], dim=-1)


def smallest_eigenvector_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]:
    the best-conditioned cross product of two rows of (A - lambda_min I),
    the first of the largest norm; +z on a degenerate spectrum."""
    lam = eigenvalues_sym3(A)[..., 0]
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cs = torch.stack(
        [torch.cross(r0, r1, dim=-1), torch.cross(r1, r2, dim=-1), torch.cross(r2, r0, dim=-1)],
        dim=-2,
    )
    ns = torch.sum(cs * cs, dim=-1)
    best = torch.argmax(ns, dim=-1)
    v = torch.take_along_dim(cs, best[..., None, None].expand(best.shape + (1, 3)), dim=-2)[..., 0, :]
    nbest = torch.take_along_dim(ns, best[..., None], dim=-1)[..., 0]
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device).expand(v.shape)
    v = torch.where((nbest > 1e-20)[..., None], v, fallback)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-20)
