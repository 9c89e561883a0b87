"""APDGICP registration, structure-of-arrays path (port of
``rivslam_tpu/frontend/apdgicp_fast.py``), batched over B problems.

Every per-point quantity lives in component tensors of shape [B, N], as in
the reference. H = J^T M J with J = [skew(p) | -I] uses:
    C[:,j] = p x m_j          (m_j = columns of M)
    H_rr[:,j] = p x C[j,:],  H_rt = C,  H_tt = M
    b_rot = -(p x (M e)),    b_trans = -(M e)

The reference vmaps two nested ``lax.while_loop``s over problems. Here the
shared LM loop (``apdgicp.solve_lm``, or its CUDA graphs on the card) runs
all B problems with per-problem done masks, for the outer LM loop (at most
``max_iterations``) and the inner lambda search (always
``lm_max_iterations`` tries, each masked); each problem's state follows the
reference's control flow exactly. ``fast_problem`` holds the registration's
fixed inputs and ``fast_model`` the functions of one iteration over them.

The KNN covariance threshold is the EXACT k-th neighbour distance
(``torch.topk``); the reference uses ``lax.approx_min_k``, which is exact on
XLA:CPU, where the tests compare the two.
"""

from __future__ import annotations

import math

import torch

from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.core.pointcloud import SENTINEL
from rivslam_tpu_torch.frontend.apdgicp import (
    GraphedRegistration, PreparedCloud, RegistrationResult, run_registration,
)
from rivslam_tpu_torch.ops import eig3, nn_gather


def _self_sqdist(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, N, N] expanded-form distances with invalid rows at the sentinel."""
    sent = torch.where(mask[..., None], xyz, SENTINEL)
    n2 = torch.sum(sent * sent, dim=-1)
    return n2[:, :, None] + n2[:, None, :] - 2.0 * torch.bmm(sent, sent.transpose(1, 2))


def estimate_covariances_fast(
    xyz: torch.Tensor, mask: torch.Tensor, cfg: RegistrationConfig
) -> PreparedCloud:
    """k-NN covariances (PLANE only): a 0/1 selection matrix
    W = (d2 <= k-th distance) turns the neighbour sums into one matmul."""
    d2 = _self_sqdist(xyz, mask)
    kth = torch.topk(d2, cfg.k_correspondences, dim=-1, largest=False).values[..., -1]
    W = ((d2 <= kth[..., None]) & mask[:, None, :]).to(xyz.dtype)  # [B, N, M]
    return _weighted_moments_to_prepared(xyz, mask, W)


def estimate_covariances_rbf_fast(
    xyz: torch.Tensor, mask: torch.Tensor, cfg: RegistrationConfig
) -> PreparedCloud:
    """RBF-kernel covariances (PLANE only), GPU_RBF_KERNEL parity
    (covariance_estimation_rbf.cu:78-160): all points weighted by
    w = exp(-kernel_width * d2), zeroed beyond max_dist."""
    d2 = torch.clamp_min(_self_sqdist(xyz, mask), 0.0)
    md2 = cfg.rbf_max_dist * cfg.rbf_max_dist
    # reference quirk: kernel_width is the exponent factor itself (cu:80)
    W = torch.exp(-cfg.rbf_kernel_width * d2)
    W = torch.where((d2 <= md2) & mask[:, None, :], W, 0.0).to(xyz.dtype)
    return _weighted_moments_to_prepared(xyz, mask, W)


def _weighted_moments_to_prepared(
    xyz: torch.Tensor, mask: torch.Tensor, W: torch.Tensor
) -> PreparedCloud:
    """Weighted neighbour moments -> covariance -> closed-form PLANE
    regularization (cov = E_w[xx^T] - mean mean^T)."""
    x, y, z = xyz.unbind(-1)
    feats = torch.stack(
        [torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z], dim=-1
    )  # [B, M, 10]
    acc = torch.bmm(W, feats)  # [B, N, 10]
    cnt = torch.clamp_min(acc[..., 0], 1e-6)
    mx, my, mz = acc[..., 1] / cnt, acc[..., 2] / cnt, acc[..., 3] / cnt
    c00 = acc[..., 4] / cnt - mx * mx
    c01 = acc[..., 5] / cnt - mx * my
    c02 = acc[..., 6] / cnt - mx * mz
    c11 = acc[..., 7] / cnt - my * my
    c12 = acc[..., 8] / cnt - my * mz
    c22 = acc[..., 9] / cnt - mz * mz
    r = eig3.plane_regularize_soa(c00, c01, c02, c11, c12, c22, 1e-3)
    cov = torch.stack(
        [
            torch.stack([r[0], r[1], r[2]], dim=-1),
            torch.stack([r[1], r[3], r[4]], dim=-1),
            torch.stack([r[2], r[4], r[5]], dim=-1),
        ],
        dim=-2,
    )
    return PreparedCloud(xyz=xyz, mask=mask, cov=cov)


def _soa_cov(cov):
    """[B,N,3,3] -> 6 component tensors (symmetric)."""
    return (
        cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2],
    )


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _sym_inv3(m00, m01, m02, m11, m12, m22):
    """Adjugate inverse of a symmetric 3x3 in component form."""
    A = m11 * m22 - m12 * m12
    B = m02 * m12 - m01 * m22
    C = m01 * m12 - m02 * m11
    det = m00 * A + m01 * B + m02 * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1.0, det)
    i00 = A * inv_det
    i01 = B * inv_det
    i02 = C * inv_det
    i11 = (m00 * m22 - m02 * m02) * inv_det
    i12 = (m02 * m01 - m00 * m12) * inv_det
    i22 = (m00 * m11 - m01 * m01) * inv_det
    return i00, i01, i02, i11, i12, i22


def _rot_sym_rot_t(Rc, c00, c01, c02, c11, c12, c22):
    """R C R^T per problem; Rc is R as [B, 3, 3, 1], C in [B, N] components."""
    rows = []
    for k in range(3):
        rk0, rk1, rk2 = Rc[:, k, 0], Rc[:, k, 1], Rc[:, k, 2]
        rows.append((
            c00 * rk0 + c01 * rk1 + c02 * rk2,
            c01 * rk0 + c11 * rk1 + c12 * rk2,
            c02 * rk0 + c12 * rk1 + c22 * rk2,
        ))

    # (R C R^T)_{kj} = R[j,:] . y_k
    def dot_row(j, y):
        return Rc[:, j, 0] * y[0] + Rc[:, j, 1] * y[1] + Rc[:, j, 2] * y[2]

    return (
        dot_row(0, rows[0]), dot_row(1, rows[0]), dot_row(2, rows[0]),
        dot_row(1, rows[1]), dot_row(2, rows[1]), dot_row(2, rows[2]),
    )


def _adaptive_cov_soa(px, py, pz, cfg: RegistrationConfig):
    """APD covariance components (fast_apdgicp_impl.hpp:163-184), SoA form:
    C_dist = R diag(s^2) R^T with R = Rz(az) Ry(el), el measured from +z."""
    d2 = px * px + py * py + pz * pz
    dist = torch.sqrt(torch.clamp_min(d2, 1e-12))
    rho = torch.sqrt(torch.clamp_min(py * py + pz * pz, 1e-24))
    cos_aoa = rho / dist
    safe_cos = torch.clamp_min(cos_aoa, 1e-6)
    s_x = dist * (cfg.dist_var / 400.0)
    s_y = dist * (math.sin(math.radians(cfg.azimuth_var))) / safe_cos
    s_z = dist * (math.sin(math.radians(cfg.elevation_var))) / safe_cos
    sx2, sy2, sz2 = s_x * s_x, s_y * s_y, s_z * s_z
    rxy = torch.sqrt(torch.clamp_min(px * px + py * py, 1e-24))
    ca = px / rxy
    sa = py / rxy
    se = rxy / dist
    ce = pz / dist
    u0x, u0y, u0z = ce * ca, ce * sa, -se
    u1x, u1y, u1z = -sa, ca, torch.zeros_like(sa)
    u2x, u2y, u2z = se * ca, se * sa, ce
    c00 = sx2 * u0x * u0x + sy2 * u1x * u1x + sz2 * u2x * u2x
    c01 = sx2 * u0x * u0y + sy2 * u1x * u1y + sz2 * u2x * u2y
    c02 = sx2 * u0x * u0z + sy2 * u1x * u1z + sz2 * u2x * u2z
    c11 = sx2 * u0y * u0y + sy2 * u1y * u1y + sz2 * u2y * u2y
    c12 = sx2 * u0y * u0z + sy2 * u1y * u1z + sz2 * u2y * u2z
    c22 = sx2 * u0z * u0z + sy2 * u1z * u1z + sz2 * u2z * u2z
    return c00, c01, c02, c11, c12, c22


def fast_problem(source: PreparedCloud, target: PreparedCloud) -> tuple:
    """The fixed inputs of a fast registration: the source's xyz, mask and
    covariance, the target with masked rows at the sentinel, its mask, and
    its xyz and covariance components as [B, 9, M], the layout K1 gathers
    from and returns ([B, 9, N]); the flag-off path gathers the same rows."""
    tmask = target.mask.contiguous()
    tgt_sent = torch.where(tmask[..., None], target.xyz, SENTINEL).contiguous()
    t_c = _soa_cov(target.cov)
    tgt_feats_t = torch.stack(list(target.xyz.unbind(-1)) + list(t_c), dim=1).contiguous()
    return (source.xyz.contiguous(), source.mask.contiguous(), source.cov.contiguous(),
            tgt_sent, tmask, tgt_feats_t)


def fast_model(src_xyz, smask, src_cov, tgt_sent, tmask, tgt_feats_t, cfg: RegistrationConfig):
    """``apdgicp.run_registration``'s functions for the fast path over
    ``fast_problem``'s inputs."""
    dtype = src_xyz.dtype
    B = src_xyz.shape[0]
    sx0, sy0, sz0 = src_xyz.unbind(-1)  # [B, N]
    s_c = _soa_cov(src_cov)
    # the flag-off path's target norms [B, M]
    tn2 = None if cfg.use_pallas_correspondence else torch.sum(tgt_sent * tgt_sent, dim=-1)
    max_d2 = cfg.max_correspondence_distance**2

    def transform(T):
        Rc = T[:, :3, :3, None]  # [B, 3, 3, 1] broadcasts over points
        tc = T[:, :3, 3, None]
        px = Rc[:, 0, 0] * sx0 + Rc[:, 0, 1] * sy0 + Rc[:, 0, 2] * sz0 + tc[:, 0]
        py = Rc[:, 1, 0] * sx0 + Rc[:, 1, 1] * sy0 + Rc[:, 1, 2] * sz0 + tc[:, 1]
        pz = Rc[:, 2, 0] * sx0 + Rc[:, 2, 1] * sy0 + Rc[:, 2, 2] * sz0 + tc[:, 2]
        return Rc, (px, py, pz)

    def correspondences(T):
        Rc, (px, py, pz) = transform(T)
        p = torch.stack([px, py, pz], dim=-1)
        if cfg.use_pallas_correspondence:
            best, g_t = nn_gather.fused_gather(p, tgt_sent, tmask, tgt_feats_t)
            best = best.to(dtype)
            g_t = g_t.to(dtype)
        else:
            # matmul cross term, argmin, then gather of the winner's row
            cross = torch.bmm(p, tgt_sent.transpose(1, 2))
            d2 = (px * px + py * py + pz * pz)[..., None] + tn2[:, None, :] - 2.0 * cross
            idx = torch.argmin(d2, dim=-1)
            best = torch.take_along_dim(d2, idx[..., None], dim=-1)[..., 0]
            g_t = torch.gather(tgt_feats_t, 2, idx[:, None, :].expand(-1, 9, -1))
        w = (smask & (best < max_d2)).to(dtype)
        gx, gy, gz, b00, b01, b02, b11, b12, b22 = g_t.unbind(1)
        a00, a01, a02, a11, a12, a22 = _rot_sym_rot_t(Rc, *s_c)
        if cfg.method == "FAST_APDGICP":
            dc = _adaptive_cov_soa(px, py, pz, cfg)
            # (cov_B + cd) + R (cov_A + cd') R^T with cd evaluated at the
            # transformed point both times (reference semantics: same cd)
            e00, e01, e02, e11, e12, e22 = _rot_sym_rot_t(Rc, *dc)
            d00, d01, d02, d11, d12, d22 = dc
            r = (
                b00 + d00 + a00 + e00, b01 + d01 + a01 + e01, b02 + d02 + a02 + e02,
                b11 + d11 + a11 + e11, b12 + d12 + a12 + e12, b22 + d22 + a22 + e22,
            )
        else:
            r = (b00 + a00, b01 + a01, b02 + a02, b11 + a11, b12 + a12, b22 + a22)
        m = tuple(mi * w for mi in _sym_inv3(*r))
        return w, m, (gx, gy, gz), best, (px, py, pz)

    def linearize(p, m, g):
        px, py, pz = p
        gx, gy, gz = g
        ex, ey, ez = gx - px, gy - py, gz - pz
        m00, m01, m02, m11, m12, m22 = m
        qx = m00 * ex + m01 * ey + m02 * ez
        qy = m01 * ex + m11 * ey + m12 * ez
        qz = m02 * ex + m12 * ey + m22 * ez
        err = torch.sum(ex * qx + ey * qy + ez * qz, dim=-1)
        br = _cross(px, py, pz, qx, qy, qz)
        c = [_cross(px, py, pz, *col) for col in ((m00, m01, m02), (m01, m11, m12), (m02, m12, m22))]
        # h_rr[j] = p x (row j of C); row j of C = (c0[j], c1[j], c2[j])
        h_rr = [_cross(px, py, pz, c[0][j], c[1][j], c[2][j]) for j in range(3)]
        rows = [[h_rr[0][i], h_rr[1][i], h_rr[2][i], c[0][i], c[1][i], c[2][i]] for i in range(3)]
        mrows = ((m00, m01, m02), (m01, m11, m12), (m02, m12, m22))
        rows += [[c[j][0], c[j][1], c[j][2], *mrows[j]] for j in range(3)]
        H = torch.stack([e for row in rows for e in row], dim=1).sum(dim=-1).view(B, 6, 6)
        b = -torch.stack([*br, qx, qy, qz], dim=1).sum(dim=-1)
        return H, b, err

    def compute_error(T, m, g):
        _, (px, py, pz) = transform(T)
        gx, gy, gz = g
        ex, ey, ez = gx - px, gy - py, gz - pz
        m00, m01, m02, m11, m12, m22 = m
        return torch.sum(
            ex * (m00 * ex + m01 * ey + m02 * ez)
            + ey * (m01 * ex + m11 * ey + m12 * ez)
            + ez * (m02 * ex + m12 * ey + m22 * ez),
            dim=-1,
        )

    def linearize_at(T):
        w, m, g, best, p = correspondences(T)
        H, b, y0 = linearize(p, m, g)
        return H, b, y0, (m, g)

    def error_at(T, ctx):
        return compute_error(T, *ctx)

    def final_at(T):
        w, m, g, best, p = correspondences(T)
        ncorr = torch.sum(w, dim=-1)
        fitness = torch.sum(torch.where(w > 0, best, 0.0), dim=-1) / torch.clamp_min(ncorr, 1)
        _, _, final_err = linearize(p, m, g)
        return final_err, ncorr.to(torch.int32), fitness

    return linearize_at, error_at, final_at


def register_fast(
    source: PreparedCloud,
    target: PreparedCloud,
    guess: torch.Tensor,
    cfg: RegistrationConfig,
    graphs: GraphedRegistration | None = None,
) -> RegistrationResult:
    """Batched counterpart of the reference's register_fast: B problems,
    source/target fields [B, N, ...], guess [B, 4, 4]; ``graphs`` as in
    ``apdgicp.run_registration``."""
    return run_registration(fast_model, fast_problem(source, target),
                            guess.to(source.xyz.dtype), cfg, graphs)
