"""SO(3)/SE(3) Lie-group math (port of ``rivslam_tpu/core/lie.py``).

What the scan match, the odometry and the window backend use: hat, so3
exp/log and their Jacobians, the SE(3) 4x4 helpers, the geodesic angle,
re-orthonormalisation and yaw-pitch-roll; and the quaternion helpers of the
I/O boundary ([w, x, y, z]). Branch-free like the reference:
small angles take Taylor expansions through ``torch.where``, and every
function is batched over leading dims, keeps its input's dtype and device,
and runs under ``torch.func.vmap``/``jacfwd`` (no in-place writes into
inputs, no host reads).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(shape)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector; batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _sin_x_over_x(x2: torch.Tensor) -> torch.Tensor:
    """sin(sqrt(x2))/sqrt(x2), Taylor near 0. x2 = theta^2."""
    small = x2 < _EPS
    x = torch.sqrt(torch.where(small, 1.0, x2))
    return torch.where(small, 1.0 - x2 / 6.0, torch.sin(x) / x)


def _one_minus_cos_over_x2(x2: torch.Tensor) -> torch.Tensor:
    """(1-cos(theta))/theta^2 with Taylor near 0."""
    small = x2 < _EPS
    safe2 = torch.where(small, 1.0, x2)
    x = torch.sqrt(safe2)
    return torch.where(small, 0.5 - x2 / 24.0, (1.0 - torch.cos(x)) / safe2)


def _x_minus_sin_over_x3(x2: torch.Tensor) -> torch.Tensor:
    """(theta-sin(theta))/theta^3 with Taylor near 0."""
    small = x2 < _EPS
    safe2 = torch.where(small, 1.0, x2)
    x = torch.sqrt(safe2)
    return torch.where(small, 1.0 / 6.0 - x2 / 120.0, (x - torch.sin(x)) / (safe2 * x))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle 3-vector -> rotation matrix. Batched."""
    theta2 = torch.sum(w * w, dim=-1)
    a = _sin_x_over_x(theta2)[..., None, None]
    b = _one_minus_cos_over_x2(theta2)[..., None, None]
    W = hat(w)
    return _eye(3, w, W.shape) + a * W + b * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle 3-vector; robust near 0 and pi. Batched."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = 0.5 * vee(R - R.transpose(-1, -2))
    s2 = torch.sum(w_skew * w_skew, dim=-1)  # sin^2(theta)
    near_pi = cos_theta < -1.0 + 1e-11
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, 1.0, s2))
    theta = torch.atan2(s, cos_theta)
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / s)
    w_generic = w_skew * scale[..., None]
    # near pi: axis from the largest diagonal entry of (R + I)/2
    B = (R + _eye(3, R, R.shape)) / 2.0
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.take_along_dim(B, k[..., None, None].expand(B.shape[:-1] + (1,)), dim=-1)[..., 0]
    axis = col / torch.linalg.norm(col, dim=-1, keepdim=True).clamp_min(_EPS)
    sign = torch.where(torch.sum(axis * w_skew, dim=-1) < 0.0, -1.0, 1.0)
    w_pi = axis * (sign * theta)[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jr(w) = I - (1-cos)/t^2 W + (t - sin)/t^3 W^2. Batched."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    b = _one_minus_cos_over_x2(theta2)[..., None, None]
    c = _x_minus_sin_over_x3(theta2)[..., None, None]
    return _eye(3, w, W.shape) - b * W + c * (W @ W)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (R, t) into a homogeneous 4x4. Batched."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # the row [0, 0, 0, 1] filled on the device (no copy from the host, which
    # a CUDA graph capture refuses)
    bottom = torch.cat([torch.zeros(batch + (1, 3), dtype=R.dtype, device=R.device),
                        torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of homogeneous 4x4. Batched."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return se3_matrix(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform(s) to [..., N, 3] points (rigid)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
