"""Global pose-graph optimization over all keyframes (port of
``rivslam_tpu/loop/global_graph.py``).

The graph lives in fixed-capacity tensors (poses [K], consecutive odometry
edges implicit, loop edges [L]); ``solve_pose_graph`` runs Gauss-Newton
steps whose normal equations are solved by block-Jacobi-preconditioned
conjugate gradients, with the matvec assembled edge-wise. The reference's
``lax.scan``s become fixed-count loops. ``loop/block_schur.py`` holds the
default solver (``global_solver="SCHUR"``); it shares this module's graph,
edges and linearization.

Edge Jacobians are closed-form: the reference differentiates the 2-pose
residual with ``jax.jacfwd`` through right-multiplicative retractions of
both poses; here they are written out (``_edge_res_and_jac``), and the
tests hold them against ``torch.func.jacfwd`` of the same residual.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.factors import residuals, robust


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Fixed-capacity pose graph.

    Consecutive odometry edges connect (i-1, i) for every valid i>0 with
    measurement rel_T[i] = T_{i-1}^-1 T_i (forward convention, unlike the
    window's backward one). Loop edges connect arbitrary pairs.
    """

    R: torch.Tensor  # [K,3,3] pose estimates
    p: torch.Tensor  # [K,3]
    node_mask: torch.Tensor  # [K]
    odom_rel_R: torch.Tensor  # [K,3,3] measurement for edge (i-1, i)
    odom_rel_p: torch.Tensor  # [K,3]
    odom_info: torch.Tensor  # [K,6,6]
    loop_i: torch.Tensor  # [L] int64 source (older) node
    loop_j: torch.Tensor  # [L] int64 target (newer) node
    loop_rel_R: torch.Tensor  # [L,3,3] measurement T_i^-1 T_j
    loop_rel_p: torch.Tensor  # [L,3]
    loop_info: torch.Tensor  # [L,6,6]
    loop_mask: torch.Tensor  # [L]
    anchor_info: torch.Tensor  # [6,6] prior on node 0 (reference anchor_edge)
    gps_xyz: torch.Tensor  # [K,3] GPS/UTM position priors (EdgeSE3PriorXYZ)
    gps_info: torch.Tensor  # [K,3] diagonal information
    gps_mask: torch.Tensor  # [K]

    @staticmethod
    def create(capacity: int, loop_capacity: int, dtype=torch.float32, device="cpu") -> "PoseGraph":
        K, L = capacity, loop_capacity

        def eye(n, *lead):
            return torch.eye(n, dtype=dtype, device=device).repeat(*lead, 1, 1)

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return PoseGraph(
            R=eye(3, K), p=zeros(K, 3), node_mask=zeros(K, dt=torch.bool),
            odom_rel_R=eye(3, K), odom_rel_p=zeros(K, 3), odom_info=eye(6, K),
            loop_i=zeros(L, dt=torch.int64), loop_j=zeros(L, dt=torch.int64),
            loop_rel_R=eye(3, L), loop_rel_p=zeros(L, 3), loop_info=eye(6, L),
            loop_mask=zeros(L, dt=torch.bool),
            # reference fix_first_node_stddev "10 10 10 1 1 1" -> info diag
            anchor_info=torch.diag(torch.tensor([1.0, 1.0, 1.0, 0.1, 0.1, 0.1], dtype=dtype,
                                                device=device)),
            gps_xyz=zeros(K, 3), gps_info=torch.ones((K, 3), dtype=dtype, device=device),
            gps_mask=zeros(K, dt=torch.bool),
        )


def _edge_residual(Ri, pi, Rj, pj, Rm, pm):
    """r = [log(Rm^T Ri^T Rj); Ri^T (pj - pi) - pm]."""
    return residuals.relative_se3(Ri, pi, Rj, pj, Rm, pm)


def _edge_res_and_jac(Ri, pi, Rj, pj, Rm, pm):
    """Residual + Jacobians [..., 6, 6] w.r.t. the right-multiplicative
    tangents (dw, dp) of poses i and j (Ri exp(dw), pi + dp), batched.

    With A = Ri^T Rj, e = log(Rm^T A) and v = Ri^T (pj - pi):
        dr/d(i) = [[-Jr^-1(e) A^T, 0], [hat(v), -Ri^T]]
        dr/d(j) = [[ Jr^-1(e),     0], [0,       Ri^T]]."""
    r = _edge_residual(Ri, pi, Rj, pj, Rm, pm)
    RiT = Ri.transpose(-1, -2)
    A = RiT @ Rj
    Jr_inv = lie.so3_right_jacobian_inv(r[..., :3])
    v = (RiT @ (pj - pi)[..., None])[..., 0]
    zero = torch.zeros_like(A)
    Ji = torch.cat([
        torch.cat([-Jr_inv @ A.transpose(-1, -2), zero], dim=-1),
        torch.cat([lie.hat(v), -RiT], dim=-1),
    ], dim=-2)
    Jj = torch.cat([
        torch.cat([Jr_inv, zero], dim=-1),
        torch.cat([zero, RiT], dim=-1),
    ], dim=-2)
    return r, Ji, Jj


def _gather_edges(g: PoseGraph):
    """All edges as flat (i, j, Rm, pm, info, mask, is_loop) arrays: the
    odometry edges (i-1, i) followed by the loop edges."""
    K = g.R.shape[0]
    ar = torch.arange(K, device=g.R.device)
    odom_i = torch.clamp_min(ar - 1, 0)
    odom_mask = g.node_mask & torch.roll(g.node_mask, 1) & (ar > 0)
    ei = torch.cat([odom_i, g.loop_i])
    ej = torch.cat([ar, g.loop_j])
    Rm = torch.cat([g.odom_rel_R, g.loop_rel_R])
    pm = torch.cat([g.odom_rel_p, g.loop_rel_p])
    info = torch.cat([g.odom_info, g.loop_info])
    mask = torch.cat([odom_mask, g.loop_mask])
    # robust kernel flag: loop edges get Huber 1.0 (launch:163-164)
    is_loop = torch.cat([torch.zeros_like(g.node_mask), torch.ones_like(g.loop_mask)])
    return ei, ej, Rm, pm, info, mask, is_loop


def _robust_weights(r, info, mask, is_loop, huber_delta):
    chi2_e = torch.einsum("eij,ei,ej->e", info, r, r)
    w = torch.where(is_loop, robust.kernel_weight("Huber", huber_delta, chi2_e), 1.0)
    return chi2_e, w * mask.to(r.dtype)


def linearize(g: PoseGraph, huber_delta: float = 1.0):
    """Per-edge residuals, Jacobians, IRLS-weighted infos; plus chi2."""
    ei, ej, Rm, pm, info, mask, is_loop = _gather_edges(g)
    r, Ji, Jj = _edge_res_and_jac(g.R[ei], g.p[ei], g.R[ej], g.p[ej], Rm, pm)
    chi2_e, w = _robust_weights(r, info, mask, is_loop, huber_delta)
    W = info * w[:, None, None]
    return ei, ej, r, Ji, Jj, W, torch.sum(chi2_e * w)


def _scatter(K: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Sum vals [E, ...] into K rows by idx (the reference's .at[idx].add)."""
    return torch.zeros((K,) + vals.shape[1:], dtype=vals.dtype, device=vals.device).index_add_(0, idx, vals)


def _gps_weights(g: PoseGraph, dtype) -> torch.Tensor:
    return g.gps_info * g.gps_mask[:, None].to(dtype)


def _build_rhs_and_diag(g: PoseGraph, ei, ej, r, Ji, Jj, W, reduce=None):
    """gradient = sum J^T W r scattered per node; block-diagonal of H.
    ``reduce`` sums the edges' parts over the ranks that hold the other
    edges (``dist/dist_graph.py``); the priors are added once, after it."""
    K = g.R.shape[0]
    Wr = torch.einsum("eij,ej->ei", W, r)
    grad = _scatter(K, ei, torch.einsum("eji,ej->ei", Ji, Wr)) + _scatter(
        K, ej, torch.einsum("eji,ej->ei", Jj, Wr))
    Hii = torch.einsum("eji,ejk,ekl->eil", Ji, W, Ji)
    Hjj = torch.einsum("eji,ejk,ekl->eil", Jj, W, Jj)
    diag = _scatter(K, ei, Hii) + _scatter(K, ej, Hjj)
    if reduce is not None:
        grad, diag = reduce(grad), reduce(diag)
    # anchor prior on node 0 (identity-measurement EdgeSE3 to a fixed node,
    # nodelet:689-691) + tiny Tikhonov so unconstrained nodes stay put
    anchor_r = torch.cat([lie.so3_log(g.R[0]), g.p[0]])
    diag[0] += g.anchor_info
    grad[0] += g.anchor_info @ anchor_r
    # GPS/UTM position priors (EdgeSE3PriorXYZ, unary on translation: the
    # residual p - gps has Jacobian [0 | I] in the (theta, p) tangent)
    w_gps = _gps_weights(g, r.dtype)
    grad[:, 3:] += w_gps * (g.p - g.gps_xyz)
    diag[:, 3:, 3:] += torch.diag_embed(w_gps)
    diag = diag + torch.eye(6, dtype=r.dtype, device=r.device) * 1e-6
    return grad, diag


def _hvp(g: PoseGraph, ei, ej, Ji, Jj, W, v, reduce=None):
    """H v with H = sum_e J_e^T W_e J_e (+ anchor, GPS, Tikhonov), v [K,6];
    ``reduce`` as in ``_build_rhs_and_diag``."""
    K = g.R.shape[0]
    Jv = torch.einsum("eij,ej->ei", Ji, v[ei]) + torch.einsum("eij,ej->ei", Jj, v[ej])
    WJv = torch.einsum("eij,ej->ei", W, Jv)
    out = _scatter(K, ei, torch.einsum("eji,ej->ei", Ji, WJv)) + _scatter(
        K, ej, torch.einsum("eji,ej->ei", Jj, WJv))
    if reduce is not None:
        out = reduce(out)
    out[0] += g.anchor_info @ v[0]
    out[:, 3:] += _gps_weights(g, v.dtype) * v[:, 3:]
    return out + 1e-6 * v


def gps_chi2(g: PoseGraph, p: torch.Tensor) -> torch.Tensor:
    gps_r = (p - g.gps_xyz) * g.gps_mask[:, None].to(p.dtype)
    return torch.sum(g.gps_info * gps_r * gps_r)


def solve_pose_graph(
    g: PoseGraph, gn_iters: int = 10, cg_iters: int = 64, huber_delta: float = 1.0
) -> tuple[PoseGraph, torch.Tensor]:
    """Gauss-Newton with block-Jacobi-preconditioned CG. Returns (graph, chi2)."""
    return gauss_newton_pcg(g, lambda gc: linearize(gc, huber_delta), gn_iters, cg_iters)


def gauss_newton_pcg(g: PoseGraph, linearize_fn, gn_iters: int, cg_iters: int, reduce=None):
    """``solve_pose_graph``'s iterations over the edges ``linearize_fn(g)``
    linearizes (``linearize``'s tuple); ``reduce`` sums the edge-wise parts
    over the ranks that hold the other edges (``dist/dist_graph.py``).
    Returns (graph, the chi2 of ``linearize_fn`` at the solution)."""
    for _ in range(gn_iters):
        ei, ej, r, Ji, Jj, W, _ = linearize_fn(g)
        grad, diag = _build_rhs_and_diag(g, ei, ej, r, Ji, Jj, W, reduce)
        Minv = torch.linalg.inv(diag)

        def precond(x):
            return torch.einsum("kij,kj->ki", Minv, x)

        b = -grad
        x = torch.zeros_like(grad)
        rr = b
        z = precond(b)
        pdir = z
        rz = torch.sum(b * z)
        for _ in range(cg_iters):
            Ap = _hvp(g, ei, ej, Ji, Jj, W, pdir, reduce)
            alpha = rz / torch.clamp_min(torch.sum(pdir * Ap), 1e-30)
            x = x + alpha * pdir
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.clamp_min(rz, 1e-30)
            pdir = z + beta * pdir
            rz = rz_new
        g = dataclasses.replace(g, R=g.R @ lie.so3_exp(x[:, :3]), p=g.p + x[:, 3:])
    return g, linearize_fn(g)[-1]


def compact(g: PoseGraph, keep, kf_count: int):
    """Compact the graph to the ``keep`` subset of nodes (the capacity
    policy: the reference's g2o graph grows without bound).

    keep must be sorted, include node 0 and kf_count-1, and include every
    active loop endpoint. Odometry edges across dropped nodes are composed,
    with the segment information approximated as mean(info_t)/len(segment).
    Runs on the host in numpy (a rare event). Returns (new_graph, old->new
    index map)."""
    keep = np.asarray(keep, dtype=np.int64)
    n = int(kf_count)
    assert keep[0] == 0 and keep[-1] == n - 1
    dev = g.p.device
    R, p, rel_R, rel_p, info = (t.cpu().numpy() for t in (g.R, g.p, g.odom_rel_R, g.odom_rel_p, g.odom_info))
    dtype = p.dtype
    K = R.shape[0]
    m = len(keep)
    old2new = {int(o): i for i, o in enumerate(keep)}

    new_R = np.broadcast_to(np.eye(3, dtype=dtype), (K, 3, 3)).copy()
    new_p = np.zeros((K, 3), dtype=dtype)
    new_rel_R = new_R.copy()
    new_rel_p = np.zeros((K, 3), dtype=dtype)
    new_info = np.broadcast_to(np.eye(6, dtype=dtype), (K, 6, 6)).copy()
    new_mask = np.zeros(K, dtype=bool)
    new_R[:m] = R[keep]
    new_p[:m] = p[keep]
    new_mask[:m] = True
    for i in range(1, m):
        a, b = int(keep[i - 1]), int(keep[i])
        T = np.eye(4, dtype=dtype)
        for t in range(a + 1, b + 1):
            Tt = np.eye(4, dtype=dtype)
            Tt[:3, :3] = rel_R[t]
            Tt[:3, 3] = rel_p[t]
            T = T @ Tt
        new_rel_R[i] = T[:3, :3]
        new_rel_p[i] = T[:3, 3]
        seg = info[a + 1:b + 1]
        new_info[i] = seg.mean(axis=0) / len(seg)

    loop_i, loop_j = g.loop_i.cpu().numpy().copy(), g.loop_j.cpu().numpy().copy()
    for e in np.flatnonzero(g.loop_mask.cpu().numpy()):
        loop_i[e] = old2new[int(loop_i[e])]
        loop_j[e] = old2new[int(loop_j[e])]

    gps_xyz, gps_info, gps_mask = (t.cpu().numpy() for t in (g.gps_xyz, g.gps_info, g.gps_mask))
    new_gps_xyz = np.zeros_like(gps_xyz)
    new_gps_info = np.ones_like(gps_info)
    new_gps_mask = np.zeros(K, dtype=bool)
    new_gps_xyz[:m] = gps_xyz[keep]
    new_gps_info[:m] = gps_info[keep]
    new_gps_mask[:m] = gps_mask[keep]

    def t(a):
        return torch.as_tensor(a, device=dev)

    new_g = dataclasses.replace(
        g, R=t(new_R), p=t(new_p), node_mask=t(new_mask), odom_rel_R=t(new_rel_R),
        odom_rel_p=t(new_rel_p), odom_info=t(new_info), loop_i=t(loop_i), loop_j=t(loop_j),
        gps_xyz=t(new_gps_xyz), gps_info=t(new_gps_info), gps_mask=t(new_gps_mask),
    )
    return new_g, old2new
