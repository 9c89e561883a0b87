"""The keyframe graph's global solve as plain float64 math, written from
the method (a pose graph of SE(3) relative-pose edges, g2o's EdgeSE3 with
a Huber kernel on loop edges), not from the program's code.

The graph is the program's ``PoseGraph`` as the program's solve received
it: node poses (R, p) with a validity mask, odometry edges (i-1, i) for
each valid node i > 0 whose predecessor is valid, loop edges (i, j), each
edge with a measurement (Rm, pm) of T_i^-1 T_j and a 6x6 information; a
prior on node 0 at the identity (``anchor_info``) and masked position
priors (``gps_*``). An edge's residual is

    r = [log(Rm^T R_i^T R_j); R_i^T (p_j - p_i) - pm],   s = r^T Omega r,

and the objective is

    G = sum_odometry s + sum_loop huber(s) + anchor + position priors,
    huber(s) = s for s <= delta^2, else 2 delta sqrt(s) - delta^2,

whose stationary points are where the kernel's iteratively reweighted
normal equations (weight huber'(s)) have a zero right-hand side.
``minimize`` runs damped Gauss-Newton on the valid nodes with a dense
Cholesky solve until G stops falling; ``excess`` is how far a graph's G
lies above that minimum, as a share of it.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.gicp import F64, hat, so3_exp


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> the rotation vector [..., 3], for angles below pi
    (the angle from atan2 of the skew part's norm and the trace)."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.linalg.norm(v, dim=-1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    th = torch.atan2(s, c)
    scale = torch.where(s > 1e-12, th / torch.clamp_min(s, 1e-300), 1.0 + s * s / 6.0)
    return v * scale[..., None]


def right_jacobian_inverse(phi: torch.Tensor) -> torch.Tensor:
    """Jr(phi)^-1 [..., 3, 3]: d log(exp(phi) exp(d)) / d d at d = 0."""
    th2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-10
    safe = torch.where(small, torch.ones_like(th), th)
    coef = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                       1.0 / (safe * safe) - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)))
    K = hat(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + 0.5 * K + coef * (K @ K)


class Graph:
    """The program's pose graph in float64 on its valid nodes."""

    def __init__(self, g, huber_delta: float = 1.0):
        valid = g.node_mask.bool()
        self.n = int(valid.sum())
        if not bool(valid[:self.n].all()):
            raise ValueError("the graph's valid nodes are not its first ones")
        n, dev = self.n, g.p.device
        self.R0, self.p0 = g.R[:n].to(F64), g.p[:n].to(F64)
        ar = torch.arange(1, n, device=dev)
        lm = g.loop_mask.bool()
        self.ei = torch.cat([ar - 1, g.loop_i[lm].long()])
        self.ej = torch.cat([ar, g.loop_j[lm].long()])
        self.Rm = torch.cat([g.odom_rel_R[1:n], g.loop_rel_R[lm]]).to(F64)
        self.pm = torch.cat([g.odom_rel_p[1:n], g.loop_rel_p[lm]]).to(F64)
        self.info = torch.cat([g.odom_info[1:n], g.loop_info[lm]]).to(F64)
        self.loop = torch.cat([torch.zeros(n - 1, dtype=torch.bool, device=dev),
                               torch.ones(int(lm.sum()), dtype=torch.bool, device=dev)])
        self.anchor = g.anchor_info.to(F64)
        self.gps = (g.gps_xyz[:n].to(F64), (g.gps_info[:n] * g.gps_mask[:n, None]).to(F64))
        self.delta = huber_delta

    def residuals(self, R, p):
        Ri, Rj, pi, pj = R[self.ei], R[self.ej], p[self.ei], p[self.ej]
        RiT = Ri.transpose(-1, -2)
        rot = so3_log(self.Rm.transpose(-1, -2) @ RiT @ Rj)
        trans = (RiT @ (pj - pi)[..., None])[..., 0] - self.pm
        return torch.cat([rot, trans], -1)

    def objective(self, R, p) -> torch.Tensor:
        r = self.residuals(R, p)
        s = torch.einsum("ei,eij,ej->e", r, self.info, r)
        d2 = self.delta * self.delta
        huber = torch.where(s <= d2, s, 2.0 * self.delta * torch.sqrt(s) - d2)
        a = torch.cat([so3_log(R[0]), p[0]])
        gps_xyz, gps_w = self.gps
        return (torch.where(self.loop, huber, s).sum() + a @ self.anchor @ a
                + torch.sum(gps_w * (p - gps_xyz) ** 2))

    def _normal_equations(self, R, p):
        """H and the right-hand side b of the reweighted Gauss-Newton
        system in the perturbations (R exp(w), p + u) of every node."""
        n = self.n
        r = self.residuals(R, p)
        s = torch.einsum("ei,eij,ej->e", r, self.info, r)
        weight = torch.where(self.loop & (s > self.delta ** 2),
                             self.delta / torch.sqrt(torch.clamp_min(s, 1e-300)), 1.0)
        W = self.info * weight[:, None, None]
        Ri, Rj, pi, pj = R[self.ei], R[self.ej], p[self.ei], p[self.ej]
        RiT = Ri.transpose(-1, -2)
        Jr = right_jacobian_inverse(r[:, :3])
        A = RiT @ Rj
        z = torch.zeros_like(A)
        Ji = torch.cat([torch.cat([-Jr @ A.transpose(-1, -2), z], -1),
                        torch.cat([hat((RiT @ (pj - pi)[..., None])[..., 0]), -RiT], -1)], -2)
        Jj = torch.cat([torch.cat([Jr, z], -1), torch.cat([z, RiT], -1)], -2)
        H = torch.zeros(n, 6, n, 6, dtype=F64, device=p.device)
        b = torch.zeros(n, 6, dtype=F64, device=p.device)
        for (a, Ja) in ((self.ei, Ji), (self.ej, Jj)):
            b.index_add_(0, a, torch.einsum("eki,ekl,el->ei", Ja, W, r))
            for (c, Jc) in ((self.ei, Ji), (self.ej, Jj)):
                blk = torch.einsum("eki,ekl,elj->eij", Ja, W, Jc)
                H.view(n * 6, n, 6).index_put_((a[:, None] * 6 + torch.arange(6, device=p.device), c[:, None]),
                                               blk, accumulate=True)
        a0 = torch.cat([so3_log(R[0]), p[0]])
        J0 = torch.block_diag(right_jacobian_inverse(a0[:3]), torch.eye(3, dtype=F64, device=p.device))
        H[0, :, 0, :] += J0.T @ self.anchor @ J0
        b[0] += J0.T @ self.anchor @ a0
        gps_xyz, gps_w = self.gps
        H[:, 3:, :, 3:] += torch.diag_embed(gps_w)[:, :, None, :] * torch.eye(n, dtype=F64, device=p.device)[:, None, :, None]
        b[:, 3:] += gps_w * (p - gps_xyz)
        return H.reshape(6 * n, 6 * n), b.reshape(-1)

    def minimize(self, R=None, p=None, iterations: int = 100):
        """(R, p, G) at the minimum that damped Gauss-Newton reaches from
        (R, p) (the graph's own poses by default): each step is solved with
        a Levenberg damping that falls after a step lowers G and grows
        tenfold until one does; it stops when no damping lowers G."""
        R = self.R0 if R is None else R.to(F64)
        p = self.p0 if p is None else p.to(F64)
        G = self.objective(R, p)
        lam = 1e-6
        for _ in range(iterations):
            H, b = self._normal_equations(R, p)
            diag = torch.diagonal(H).clamp_min(1e-12)
            moved = False
            for _ in range(12):
                L, bad = torch.linalg.cholesky_ex(H + lam * torch.diag(diag))
                if int(bad) == 0:
                    d = -torch.cholesky_solve(b[:, None], L)[:, 0].reshape(self.n, 6)
                    R_new, p_new = R @ so3_exp(d[:, :3]), p + d[:, 3:]
                    G_new = self.objective(R_new, p_new)
                    if bool(G_new < G):
                        R, p, G, moved = R_new, p_new, G_new, True
                        lam = max(lam / 10.0, 1e-12)
                        break
                lam *= 10.0
            if not moved:
                break
        return R, p, G

    def excess(self, R, p) -> float:
        """(G(R, p) - min G) / min G for the valid nodes' poses (R, p) of a
        solved graph; the minimum is sought from both the solve's input
        and (R, p), and the lower taken."""
        at = self.objective(R[:self.n].to(F64), p[:self.n].to(F64))
        least = min(float(self.minimize()[2]), float(self.minimize(R[:self.n], p[:self.n])[2]))
        return (float(at) - least) / max(least, 1e-300) if math.isfinite(least) else math.inf
