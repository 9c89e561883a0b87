"""Distributed global pose-graph optimization with the edges split over the
ranks of a mesh axis (port of ``rivslam_tpu/dist/dist_graph.py``).

Each rank linearizes its own contiguous part of the edges and computes its
part of the gradient, the block diagonal and, in every CG step, the
Hessian-vector product; ``all_reduce`` sums them over the axis, where the
reference psums. The node states are replicated (6 numbers a keyframe);
the O(edges) work is what is split. The iterations are
``loop/global_graph.solve_pose_graph``'s (``gauss_newton_pcg``), so the two
agree up to the order of the sums.
"""

from __future__ import annotations

import torch

from rivslam_tpu_torch.dist.mesh import all_sum
from rivslam_tpu_torch.loop import global_graph as gg


def _pad_edges(ei, ej, Rm, pm, info, mask, is_loop, mult):
    """The edge arrays padded with masked identity edges to a multiple of
    ``mult``."""
    pad = (-ei.shape[0]) % mult
    if pad == 0:
        return ei, ej, Rm, pm, info, mask, is_loop

    def eye(n, like):
        return torch.eye(n, dtype=like.dtype, device=like.device).expand(pad, n, n)

    def zeros(like, *shape):
        return torch.zeros((pad,) + shape, dtype=like.dtype, device=like.device)

    return (
        torch.cat([ei, zeros(ei)]), torch.cat([ej, zeros(ej)]), torch.cat([Rm, eye(3, Rm)]),
        torch.cat([pm, zeros(pm, 3)]), torch.cat([info, eye(6, info)]),
        torch.cat([mask, zeros(mask)]), torch.cat([is_loop, zeros(is_loop)]),
    )


def solve_pose_graph_sharded(
    g: gg.PoseGraph,
    mesh,
    axis: str = "model",
    gn_iters: int = 10,
    cg_iters: int = 64,
    huber_delta: float = 1.0,
) -> tuple[gg.PoseGraph, torch.Tensor]:
    """Gauss-Newton with block-Jacobi-preconditioned CG; the graph
    replicated, the edges split over ``axis``. Returns (graph, edge chi2),
    as ``global_graph.solve_pose_graph``, on every rank; as in the
    reference, this chi2 also holds the GPS priors' terms."""
    group = mesh.get_group(axis)
    n = mesh[axis].size()
    r = mesh.get_local_rank(axis)
    edges = _pad_edges(*gg._gather_edges(g), mult=n)
    E = edges[0].shape[0] // n
    ei, ej, Rm, pm, info, mask, is_loop = (t[r * E:(r + 1) * E] for t in edges)

    def linearize(gc: gg.PoseGraph):
        """This rank's edges at gc; the chi2 summed over the axis, with the
        GPS priors' terms, as the reference's."""
        rr, Ji, Jj = gg._edge_res_and_jac(gc.R[ei], gc.p[ei], gc.R[ej], gc.p[ej], Rm, pm)
        chi2_e, w = gg._robust_weights(rr, info, mask, is_loop, huber_delta)
        chi2 = all_sum(torch.sum(chi2_e * w), group) + gg.gps_chi2(gc, gc.p)
        return ei, ej, rr, Ji, Jj, info * w[:, None, None], chi2

    return gg.gauss_newton_pcg(g, linearize, gn_iters, cg_iters, reduce=lambda x: all_sum(x, group))
