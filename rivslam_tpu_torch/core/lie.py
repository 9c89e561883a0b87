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


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jl(w) = Jr(-w)."""
    return so3_right_jacobian(-w)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Jr(w)^-1 = I + W/2 + (1/t^2 - (1+cos)/(2 t sin)) W^2. Batched."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    small = theta2 < _EPS
    safe2 = torch.where(small, 1.0, theta2)
    safe_t = torch.sqrt(safe2)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe2 - (1.0 + torch.cos(safe_t)) / (2.0 * safe_t * torch.sin(safe_t)),
    )
    return _eye(3, w, W.shape) + 0.5 * W + coef[..., None, None] * (W @ W)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    return so3_right_jacobian_inv(-w)


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


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3) 4x4. xi = [omega(3), rho(3)] (rotation first). Batched."""
    w = xi[..., :3]
    rho = xi[..., 3:]
    V = so3_left_jacobian(w)
    return se3_matrix(so3_exp(w), torch.einsum("...ij,...j->...i", V, rho))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) 4x4 -> [omega, rho]. Batched."""
    w = so3_log(T[..., :3, :3])
    rho = torch.einsum("...ij,...j->...i", so3_left_jacobian_inv(w), T[..., :3, 3])
    return torch.cat([w, rho], dim=-1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform(s) to [..., N, 3] points (rigid)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Geodesic angle of a rotation matrix, radians. Batched."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation matrix back onto SO(3) (Gram-Schmidt)."""
    x = R[..., :, 0]
    y = R[..., :, 1]
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(_EPS)
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True).clamp_min(_EPS)
    z = torch.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def ypr_from_rot(R: torch.Tensor) -> torch.Tensor:
    """Yaw-pitch-roll (ZYX) from a rotation matrix."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


# ---- quaternions [w, x, y, z]: the I/O boundary (TUM files) ----------------


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), _EPS)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [w,x,y,z], branch-free (Shepperd's four
    candidates, the numerically best kept), w >= 0. Batched."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp_min(qw, 1e-12)) * 0.5
    w0, x1, y2, z3 = qw.unbind(-1)
    cand = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)], dim=-1),
        torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1)], dim=-1),
        torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2)], dim=-1),
        torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3], dim=-1),
    ], dim=-2)
    idx = torch.argmax(qw, dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, u) -> torch.Tensor:
    """Spherical interpolation; u broadcastable."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - u, torch.sin((1.0 - u) * theta) / safe)
    w1 = torch.where(small, u, torch.sin(u * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / torch.clamp_min(torch.linalg.norm(out, dim=-1, keepdim=True), _EPS)
