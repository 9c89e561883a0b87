"""Block-Schur global pose-graph solver (port of the local solver of
``rivslam_tpu/loop/block_schur.py``, the default ``global_solver="SCHUR"``).

Keyframes are partitioned into S contiguous blocks of B nodes. Block
boundary nodes and loop-edge endpoints are separators; each block
eliminates its interior by a masked Schur complement (H_II' = D H D +
(I - D) keeps shapes static), the reduced separator system is solved
densely, and the interiors back-substitute. The outer loop is a dogleg
trust region with accept/reject, not plain Gauss-Newton: on cold graphs the
exact Newton step overshoots (the reference's docstrings give the numbers).

The reference's ``lax.scan`` over trust-region steps becomes a fixed-count
loop, its inner ``while_loop`` over radii a loop capped at 8 tries that
stops at the first accepted step. The reduced system is assembled by a
scatter where the reference uses a one-hot matmul (``_eliminate_local``).
Everything runs in the graph's dtype; ``_equilibrate`` keeps the
factorizations scale-free in float32.

``solve_pose_graph_schur_sharded`` is the same solve as one SPMD program
over the ranks of a mesh axis (``dist/mesh.py``): rank d owns the blocks
[d S/n, (d+1) S/n), their chain edges and their eliminations; the reduced
system is summed with one ``all_reduce``, the step put together with one
``all_gather``, and the trust region's scalar tests summed with scalar
``all_reduce``s. The two solvers share the edge linearization
(``_edge_terms``), the block assembly (``_assemble_chain_blocks``) and the
separator slots (``_separator_slots``).
"""

from __future__ import annotations

import dataclasses

import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.dist.mesh import all_gather_rows, all_sum
from rivslam_tpu_torch.loop import global_graph as gg

MAX_RADIUS_TRIES = 8  # the reference's inner trust-region loop bound


def _equilibrate(A, rhs):
    """Jacobi scaling s = diag(A)^-1/2 with a floor relative to the
    matrix's own diagonal scale: solve (sAs)(x/s) = s rhs."""
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    floor = 1e-12 * torch.amax(torch.abs(d), dim=-1, keepdim=True) + 1e-30
    s = torch.rsqrt(torch.maximum(torch.abs(d), floor))
    As = A * s[..., :, None] * s[..., None, :]
    return As, rhs * s[..., :, None], s


def _spd_solve(A, rhs):
    """Equilibrated Cholesky solve for the batched interior systems. A block
    whose factorization fails gives NaN (as jnp.linalg.cholesky does), which
    the trust-region step then replaces by steepest descent."""
    As, rs, s = _equilibrate(A, rhs)
    L, info = torch.linalg.cholesky_ex(As)
    L = torch.where((info != 0)[..., None, None], torch.nan, L)
    y = torch.linalg.solve_triangular(L, rs, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x * s[..., :, None]


def _sep_solve(A, rhs):
    """Equilibrated row-pivoted solve for the reduced separator system
    (slightly indefinite in float32 at scale: LU, not Cholesky)."""
    As, rs, s = _equilibrate(A, rhs)
    return torch.linalg.solve_ex(As, rs)[0] * s[..., :, None]


def _slot_of(node, B):
    """Separator slot of a boundary node (first or last of its block); -1
    for any other node (loop endpoints get their own slots)."""
    blk = torch.div(node, B, rounding_mode="floor")
    return torch.where(node % B == 0, 2 * blk, torch.where(node % B == B - 1, 2 * blk + 1, -1))


def effective_blocks(capacity: int, requested: int) -> int:
    """Largest divisor of ``capacity`` that is <= ``requested``."""
    s = max(1, min(int(requested), int(capacity)))
    while capacity % s:
        s -= 1
    return s


def _anchor_r(R, p):
    return torch.cat([lie.so3_log(R[0]), p[0]])


def _edge_chi2(R, p, ei, ej, Rm, pm, info, mask, is_loop, huber_delta):
    """Robust-weighted chi2 of one edge set (no Jacobians: the form the
    trust region's retries evaluate)."""
    r = gg._edge_residual(R[ei], p[ei], R[ej], p[ej], Rm, pm)
    chi2_e, w = gg._robust_weights(r, info, mask, is_loop, huber_delta)
    return torch.sum(chi2_e * w)


def _graph_chi2(g: gg.PoseGraph, R, p, huber_delta):
    """Full LM objective: robust-weighted edge chi2 + GPS priors + anchor."""
    gcur = dataclasses.replace(g, R=R, p=p)
    anchor_r = _anchor_r(R, p)
    return (_edge_chi2(R, p, *gg._gather_edges(gcur), huber_delta) + gg.gps_chi2(g, p)
            + anchor_r @ g.anchor_info @ anchor_r)


def _dims(idx, width=6):
    """Rows idx*width .. idx*width+width-1, [..., width]."""
    return (idx * width)[..., None] + torch.arange(width, device=idx.device)


def _edge_terms(R, p, ei, ej, Rm, pm, info, mask, is_loop, huber_delta):
    """One edge set's linearization: residuals, Jacobians, the robust
    weighted infos W, the weighted chi2, and each edge's gradient and
    Hessian blocks."""
    r, Ji, Jj = gg._edge_res_and_jac(R[ei], p[ei], R[ej], p[ej], Rm, pm)
    chi2_e, w = gg._robust_weights(r, info, mask, is_loop, huber_delta)
    W = info * w[:, None, None]
    Wr = torch.einsum("eij,ej->ei", W, r)
    return dict(
        r=r, Ji=Ji, Jj=Jj, W=W, chi2=torch.sum(chi2_e * w),
        gi=torch.einsum("eji,ej->ei", Ji, Wr), gj=torch.einsum("eji,ej->ei", Jj, Wr),
        Hii=torch.einsum("eji,ejk,ekl->eil", Ji, W, Ji),
        Hij=torch.einsum("eji,ejk,ekl->eil", Ji, W, Jj),
        Hjj=torch.einsum("eji,ejk,ekl->eil", Jj, W, Jj),
    )


def _edge_quad(Ji, Jj, W, vi, vj):
    """sum_e (Ji vi + Jj vj)^T W (Ji vi + Jj vj): one edge set's part of
    v^T H v (the dogleg model's curvature)."""
    Jv = torch.einsum("eij,ej->ei", Ji, vi) + torch.einsum("eij,ej->ei", Jj, vj)
    return torch.sum(Jv * torch.einsum("eij,ej->ei", W, Jv))


def _assemble_chain_blocks(ch, loc_i, loc_j, edge_blk, Sn, B, dtype):
    """Scatter the edges' Hessian and gradient blocks into [Sn, 6B, 6B] /
    [Sn, 6B] submap blocks; ``edge_blk == Sn`` is the dump block of the
    edges that are not inside one block."""
    dev = loc_i.device
    Hb = torch.zeros((Sn + 1, 6 * B, 6 * B), dtype=dtype, device=dev)
    for vals, rows, cols in ((ch["Hii"], loc_i, loc_i), (ch["Hij"], loc_i, loc_j),
                             (ch["Hij"].transpose(1, 2), loc_j, loc_i), (ch["Hjj"], loc_j, loc_j)):
        Hb.index_put_((edge_blk[:, None, None], _dims(rows)[:, :, None], _dims(cols)[:, None, :]),
                      vals, accumulate=True)
    gb = torch.zeros((Sn + 1, 6 * B), dtype=dtype, device=dev)
    gb.index_put_((edge_blk[:, None], _dims(loc_i)), ch["gi"], accumulate=True)
    gb.index_put_((edge_blk[:, None], _dims(loc_j)), ch["gj"], accumulate=True)
    return Hb[:-1], gb[:-1]


def _separator_slots(g: gg.PoseGraph, S, B):
    """Which nodes are separators (block boundaries and active loop
    endpoints) and each node's separator slot (P = 2S + 2L, the dump slot,
    for interior nodes); and each loop edge's own endpoint slots."""
    K = g.R.shape[0]
    L = g.loop_i.shape[0]
    dev = g.R.device
    P = 2 * S + 2 * L
    node_ids = torch.arange(K, device=dev)
    sep_mask = (node_ids % B == 0) | (node_ids % B == B - 1)
    sep_mask = sep_mask.clone()
    sep_mask[g.loop_i] = sep_mask[g.loop_i] | g.loop_mask
    sep_mask[g.loop_j] = sep_mask[g.loop_j] | g.loop_mask
    slot = _slot_of(node_ids, B)
    ar_l = torch.arange(L, device=dev)
    si_b, sj_b = _slot_of(g.loop_i, B), _slot_of(g.loop_j, B)
    li_slot = torch.where(si_b >= 0, si_b, 2 * S + 2 * ar_l)
    lj_slot = torch.where(sj_b >= 0, sj_b, 2 * S + 2 * ar_l + 1)
    slot[g.loop_i] = torch.where(g.loop_mask, li_slot, slot[g.loop_i])
    slot[g.loop_j] = torch.where(g.loop_mask, lj_slot, slot[g.loop_j])
    slot = torch.where(sep_mask, torch.where(slot >= 0, slot, P), P)  # P = dump
    return sep_mask, slot, li_slot, lj_slot


def _linearize_assemble(g: gg.PoseGraph, R, p, S, B, huber_delta):
    """One iteration's damping-independent work: linearize every edge,
    scatter the per-block Hessians and gradients, the separator bookkeeping
    and the full gradient."""
    K = g.R.shape[0]
    L = g.loop_i.shape[0]
    dtype, dev = p.dtype, p.device
    P = 2 * S + 2 * L
    node_ids = torch.arange(K, device=dev)
    blk_of = torch.div(node_ids, B, rounding_mode="floor")

    gcur = dataclasses.replace(g, R=R, p=p)
    ei, ej, Rm, pm, info, mask, is_loop = gg._gather_edges(gcur)
    et = _edge_terms(R, p, ei, ej, Rm, pm, info, mask, is_loop, huber_delta)
    Ji, Jj, W, chi2_edges = et["Ji"], et["Jj"], et["W"], et["chi2"]
    g_i, g_j, H_ii, H_ij, H_jj = et["gi"], et["gj"], et["Hii"], et["Hij"], et["Hjj"]

    # ---- separator bookkeeping
    sep_mask, slot, _, _ = _separator_slots(g, S, B)
    ar_l = torch.arange(L, device=dev)

    # ---- classify edges: intra-block vs separator-only
    same_block = blk_of[ei] == blk_of[ej]
    intra = same_block & ~is_loop & mask
    sep_edge = mask & ~intra  # cross-block odometry + loop edges
    edge_blk = torch.where(intra, blk_of[ej], S)  # invalid -> dump block
    Hb, gb = _assemble_chain_blocks(et, ei % B, ej % B, edge_blk, S, B, dtype)

    # GPS priors (unary, may be interior): into the local blocks
    w_gps = gg._gps_weights(g, dtype)  # [K,3]
    gps_r = (p - g.gps_xyz) * g.gps_mask[:, None].to(dtype)
    diag_idx = _dims(node_ids % B)[:, 3:]  # the translation dims
    flat = torch.zeros((S, 6 * B), dtype=dtype, device=dev)
    flat.index_put_((blk_of[:, None], diag_idx), w_gps, accumulate=True)
    Hb = Hb + torch.diag_embed(flat)
    gb.index_put_((blk_of[:, None], diag_idx), w_gps * gps_r, accumulate=True)

    # Tikhonov keeps unconstrained dims inert
    Hb = Hb + torch.eye(6 * B, dtype=dtype, device=dev) * 1e-6

    D = torch.repeat_interleave(~sep_mask.reshape(S, B), 6, dim=1).to(dtype)  # [S, 6B]
    sdim = _dims(slot.reshape(S, B)).reshape(S, 6 * B)

    # separator-edge candidates: the S-1 block-crossing chain edges
    # k = B, 2B, ... plus the L loop edges (chain edges occupy [0, K))
    cand = torch.cat([torch.arange(1, S, device=dev) * B, K + ar_l])
    sep_c = sep_edge[cand]
    sep_terms = dict(
        se_w=sep_c.to(dtype),
        di=_dims(torch.where(sep_c, slot[ei[cand]], P)),
        dj=_dims(torch.where(sep_c, slot[ej[cand]], P)),
        H_ii=H_ii[cand], H_ij=H_ij[cand], H_jj=H_jj[cand], g_i=g_i[cand], g_j=g_j[cand],
    )

    # full gradient in node layout [K,6] (the trust region's model) and the
    # full objective = edge chi2 + GPS + anchor (see _graph_chi2)
    anchor_r = _anchor_r(R, p)
    g_full = gg._scatter(K, ei, g_i) + gg._scatter(K, ej, g_j)
    g_full[:, 3:] += w_gps * gps_r
    g_full[0] += g.anchor_info @ anchor_r
    chi2_full = chi2_edges + torch.sum(g.gps_info * gps_r * gps_r) + anchor_r @ g.anchor_info @ anchor_r
    return dict(
        Hb=Hb, gb=gb, D=D, sdim=sdim, sep=sep_terms, anchor_r=anchor_r, g_full=g_full,
        chi2=chi2_full, ei=ei, ej=ej, Ji=Ji, Jj=Jj, W=W,
    )


def _add_sep_edges(H_sep, g_sep, di, dj, w, Hii, Hij, Hjj, gi, gj):
    """Scatter separator-only edges (endpoint slot dims di, dj; weights w,
    0 for an inactive edge) into the reduced system."""
    for rows, cols, vals in ((di, di, Hii), (di, dj, Hij), (dj, di, Hij.transpose(1, 2)), (dj, dj, Hjj)):
        H_sep = H_sep.index_put((rows[:, :, None], cols[:, None, :]), vals * w[:, None, None], accumulate=True)
    g_sep = g_sep.index_put((di,), gi * w[:, None], accumulate=True)
    return H_sep, g_sep.index_put((dj,), gj * w[:, None], accumulate=True)


def _finish_sep_system(g, lin, H_sep, g_sep, Pdim):
    """Add the separator-only edge terms and the anchor prior to the reduced
    system, and the tiny Tikhonov that keeps unused slots inert."""
    s = lin["sep"]
    H_sep, g_sep = _add_sep_edges(H_sep, g_sep, s["di"], s["dj"], s["se_w"], s["H_ii"], s["H_ij"], s["H_jj"],
                                  s["g_i"], s["g_j"])
    # anchor on node 0 (slot 0: node 0 is a boundary separator)
    H_sep = H_sep.clone()
    g_sep = g_sep.clone()
    H_sep[:6, :6] += g.anchor_info
    g_sep[:6] += g.anchor_info @ lin["anchor_r"]
    H_sep = H_sep + torch.eye(Pdim, dtype=H_sep.dtype, device=H_sep.device) * 1e-6
    return H_sep, g_sep


def _eliminate_local(Hb_d, gb, D, sdim, Pdim):
    """Masked interior elimination over all blocks. The reduced system is
    the blocks' Schur complements scattered to their separator slots: the
    reference projects with a one-hot matmul Q^T S Q instead (its TPU
    scatters serialize), which gives the same values (S is zero on interior
    dims, and every separator dim has its own slot) at ~20 GFLOP a solve
    step at keyframe capacity 2048."""
    Dm = D[:, :, None] * D[:, None, :]
    H_II = Hb_d * Dm + torch.diag_embed(1.0 - D)
    H_IS = Hb_d * (D[:, :, None] * (1.0 - D)[:, None, :])
    H_SS = Hb_d * ((1.0 - D)[:, :, None] * (1.0 - D)[:, None, :])
    g_I = gb * D
    g_S = gb * (1.0 - D)
    X = _spd_solve(H_II, torch.cat([H_IS, g_I[:, :, None]], dim=2))
    HII_inv_HIS = X[:, :, :-1]
    HII_inv_gI = X[:, :, -1]
    S_blk = H_SS - torch.einsum("sij,sik->sjk", H_IS, HII_inv_HIS)
    g_blk = g_S - torch.einsum("sij,si->sj", H_IS, HII_inv_gI)
    H_sep = Hb_d.new_zeros((Pdim, Pdim)).index_put_(
        (sdim[:, :, None], sdim[:, None, :]), S_blk, accumulate=True)
    g_sep = gb.new_zeros(Pdim).index_put_((sdim,), g_blk, accumulate=True)
    return H_sep, g_sep, HII_inv_HIS, HII_inv_gI


def _back_substitute(HII_inv_HIS, HII_inv_gI, d_sep, sdim, D):
    d_S_local = d_sep[sdim]
    d_I = -HII_inv_gI - torch.einsum("sij,sj->si", HII_inv_HIS, d_S_local)
    return d_I * D + d_S_local * (1.0 - D)


def _dogleg_combine(d_n, d_sd, delta):
    """Powell dogleg point for trust radius delta."""
    nn = torch.linalg.norm(d_n)
    ns = torch.linalg.norm(d_sd)
    d_capped_sd = d_sd * (delta / torch.clamp_min(ns, 1e-30))
    diff = d_n - d_sd
    a = torch.dot(diff, diff)
    b = 2.0 * torch.dot(d_sd, diff)
    c = torch.dot(d_sd, d_sd) - delta * delta
    disc = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
    beta = (-b + torch.sqrt(disc)) / torch.clamp_min(2.0 * a, 1e-30)
    d_interp = d_sd + torch.clamp(beta, 0.0, 1.0) * diff
    return torch.where(nn <= delta, d_n, torch.where(ns >= delta, d_capped_sd, d_interp))


def _tr_step(g, R, p, delta, S, B, huber_delta, newton_fn):
    """One dogleg trust-region iteration: one elimination per
    linearization; rejected radii reuse the Newton direction."""
    K = g.R.shape[0]
    lin = _linearize_assemble(g, R, p, S, B, huber_delta)
    chi2_cur = lin["chi2"]
    gflat = lin["g_full"].reshape(-1)
    d_n = newton_fn(lin).reshape(-1)
    d_n = torch.where(torch.all(torch.isfinite(d_n)), d_n, -gflat)
    gcur = dataclasses.replace(g, R=R, p=p)

    def hvp(v):
        return gg._hvp(gcur, lin["ei"], lin["ej"], lin["Ji"], lin["Jj"], lin["W"],
                       v.reshape(K, 6)).reshape(-1)

    alpha = torch.dot(gflat, gflat) / torch.clamp_min(torch.dot(gflat, hvp(gflat)), 1e-30)
    d_sd = -alpha * gflat

    delta_i = delta
    acc = torch.zeros((), dtype=torch.bool, device=p.device)
    d_acc = torch.zeros_like(gflat)
    rho_acc = torch.zeros((), dtype=p.dtype, device=p.device)
    for _ in range(MAX_RADIUS_TRIES):
        d = _dogleg_combine(d_n, d_sd, delta_i)
        pred = -(torch.dot(gflat, d) + 0.5 * torch.dot(d, hvp(d)))
        dm = d.reshape(K, 6)
        chi2_new = _graph_chi2(g, R @ lie.so3_exp(dm[:, :3]), p + dm[:, 3:], huber_delta)
        rho = (chi2_cur - chi2_new) / torch.clamp_min(pred, 1e-30)
        acc = (chi2_new < chi2_cur) & (pred > 0) & torch.isfinite(chi2_new)
        if bool(acc):
            d_acc, rho_acc = d, rho
            break
        delta_i = delta_i * 0.25
    dnorm = torch.linalg.norm(d_acc)
    delta_out = torch.where(acc & (rho_acc > 0.75), torch.maximum(delta_i, 3.0 * dnorm), delta_i)
    dm = d_acc.reshape(K, 6)
    R_next = torch.where(acc, R @ lie.so3_exp(dm[:, :3]), R)
    p_next = torch.where(acc, p + dm[:, 3:], p)
    return R_next, p_next, delta_out


def solve_pose_graph_schur(
    g: gg.PoseGraph, num_blocks: int = 8, gn_iters: int = 8, huber_delta: float = 1.0
) -> tuple[gg.PoseGraph, torch.Tensor]:
    """Dogleg trust region with a block-Schur elimination per iteration.
    Returns (graph, edge chi2), as ``global_graph.solve_pose_graph``."""
    K = g.R.shape[0]
    L = g.loop_i.shape[0]
    S = effective_blocks(K, num_blocks)
    B = K // S
    P = 2 * S + 2 * L
    Pdim = 6 * (P + 1)

    def newton_local(lin):
        H_sep, g_sep, HII_inv_HIS, HII_inv_gI = _eliminate_local(
            lin["Hb"], lin["gb"], lin["D"], lin["sdim"], Pdim
        )
        H_sep, g_sep = _finish_sep_system(g, lin, H_sep, g_sep, Pdim)
        d_sep = _sep_solve(H_sep, -g_sep[:, None])[:, 0]
        d_sep = torch.cat([d_sep[:6 * P], torch.zeros_like(d_sep[6 * P:])])  # dump slot: nothing
        return _back_substitute(HII_inv_HIS, HII_inv_gI, d_sep, lin["sdim"], lin["D"]).reshape(K, 6)

    R, p = g.R, g.p
    delta = torch.ones((), dtype=p.dtype, device=p.device)
    for _ in range(gn_iters):
        R, p, delta = _tr_step(g, R, p, delta, S, B, huber_delta, newton_local)
    g_out = dataclasses.replace(g, R=R, p=p)
    return g_out, gg.linearize(g_out, huber_delta)[-1]


def solve_pose_graph_schur_sharded(
    g: gg.PoseGraph, mesh, axis: str = "model", num_blocks: int = 16, gn_iters: int = 8,
    huber_delta: float = 1.0,
) -> tuple[gg.PoseGraph, torch.Tensor]:
    """``solve_pose_graph_schur`` as one SPMD program over the ranks of
    ``axis``: rank d owns the blocks [d S/n, (d+1) S/n), i.e. a contiguous
    keyframe range and the chain edges ending in it. Per rank and trust
    region iteration only the owned part is computed: the chain edges'
    linearization, the block assembly, the interior eliminations (the
    dominant cost), the retries' chi2 and the back-substitution. The loop
    edges (L), the reduced separator solve and the dogleg bookkeeping are
    replicated. Per iteration: one ``all_reduce`` of the reduced system, one
    of the [K,6] gradient, one ``all_gather`` of the step, and scalar
    ``all_reduce``s for the trust region's chi2 and curvature. The sums are
    reassociated across ranks, so the result agrees with the local solver
    to rounding. Returns (graph, edge chi2) on every rank."""
    K = g.R.shape[0]
    L = g.loop_i.shape[0]
    S = num_blocks
    n = mesh[axis].size()
    if K % S != 0 or S % n != 0:
        raise ValueError(
            f"sharded block-Schur needs keyframe_capacity ({K}) divisible by "
            f"num_blocks ({S}) and num_blocks divisible by the mesh axis "
            f"({n}); pick num_blocks with block_schur.effective_blocks"
        )
    group = mesh.get_group(axis)
    d = mesh.get_local_rank(axis)
    dtype, dev = g.p.dtype, g.p.device
    B, Sn, Kn = K // S, S // n, K // n
    P = 2 * S + 2 * L
    Pdim = 6 * (P + 1)
    own = slice(d * Kn, (d + 1) * Kn)  # this rank's nodes and chain edges

    # ---- the solve's fixed bookkeeping: the local chain edges (edge j
    # joins nodes j-1 and j) and the separator structure
    jl = torch.arange(Kn, device=dev)
    jg = d * Kn + jl
    ei, ej = torch.clamp_min(jg - 1, 0), jg
    emask = g.node_mask[ei] & g.node_mask[ej] & (jg > 0)
    cross = jg % B == 0  # block-crossing chain edge (j = 0 is the dummy)
    edge_blk = torch.where(emask & ~cross, torch.div(jg, B, rounding_mode="floor") - d * Sn, Sn)
    chain = (ei, ej, g.odom_rel_R[own], g.odom_rel_p[own], g.odom_info[own], emask,
             torch.zeros(Kn, dtype=torch.bool, device=dev))
    loops = (g.loop_i, g.loop_j, g.loop_rel_R, g.loop_rel_p, g.loop_info, g.loop_mask,
             torch.ones(L, dtype=torch.bool, device=dev))

    sep_mask, slot, li_slot, lj_slot = _separator_slots(g, S, B)
    D = torch.repeat_interleave(~sep_mask[own].reshape(Sn, B), 6, dim=1).to(dtype)  # [Sn, 6B]
    sdim = _dims(slot[own].reshape(Sn, B)).reshape(Sn, 6 * B)
    # the rank's block-crossing chain edges: each lives on one rank, so it
    # enters the reduced system before the sum, once
    cre = torch.arange(Sn, device=dev) * B
    cross_w = (emask[cre] & cross[cre]).to(dtype)
    cross_di = _dims(torch.where(cross_w > 0, slot[ei[cre]], P))
    cross_dj = _dims(torch.where(cross_w > 0, slot[ej[cre]], P))
    loop_w = g.loop_mask.to(dtype)
    loop_di = _dims(torch.where(g.loop_mask, li_slot, P))
    loop_dj = _dims(torch.where(g.loop_mask, lj_slot, P))
    gps_blk = torch.div(jl, B, rounding_mode="floor")
    gps_idx = _dims(jl % B)[:, 3:]  # the translation dims
    gps_xyz, gps_info = g.gps_xyz[own], g.gps_info[own]
    gps_m = g.gps_mask[own][:, None].to(dtype)
    w_gps = gps_info * gps_m
    anchor = g.anchor_info

    def gps_r(p):
        return (p[own] - gps_xyz) * gps_m

    def chi2_full(R, p):
        """The accept/reject objective, as the local ``_graph_chi2``."""
        c = all_sum(_edge_chi2(R, p, *chain, huber_delta) + torch.sum(gps_info * gps_r(p) ** 2), group)
        anchor_r = _anchor_r(R, p)
        return c + _edge_chi2(R, p, *loops, huber_delta) + anchor_r @ anchor @ anchor_r

    def quad(ch, lp, v):
        """v^T H v over the full damped system, v [K, 6]."""
        t = all_sum(_edge_quad(ch["Ji"], ch["Jj"], ch["W"], v[ei], v[ej])
                    + torch.sum(w_gps * v[own, 3:] * v[own, 3:]), group)
        t = t + _edge_quad(lp["Ji"], lp["Jj"], lp["W"], v[g.loop_i], v[g.loop_j])
        return t + v[0] @ anchor @ v[0] + 1e-6 * torch.sum(v * v)

    R, p = g.R, g.p
    delta = torch.ones((), dtype=dtype, device=dev)
    for _ in range(gn_iters):
        ch = _edge_terms(R, p, *chain, huber_delta)
        lp = _edge_terms(R, p, *loops, huber_delta)
        gr = gps_r(p)
        anchor_r = _anchor_r(R, p)
        chi2_cur = (all_sum(ch["chi2"] + torch.sum(gps_info * gr * gr), group) + lp["chi2"]
                    + anchor_r @ anchor @ anchor_r)

        # the full gradient, replicated after the sum
        g_loc = gg._scatter(K, ei, ch["gi"]) + gg._scatter(K, ej, ch["gj"])
        g_loc[own, 3:] += w_gps * gr
        g_full = all_sum(g_loc, group) + gg._scatter(K, g.loop_i, lp["gi"]) + gg._scatter(K, g.loop_j, lp["gj"])
        g_full[0] += anchor @ anchor_r
        gflat = g_full.reshape(-1)

        # the rank's blocks, eliminated; the reduced system summed
        Hb, gb = _assemble_chain_blocks(ch, ei % B, ej % B, edge_blk, Sn, B, dtype)
        flat = torch.zeros((Sn, 6 * B), dtype=dtype, device=dev)
        flat.index_put_((gps_blk[:, None], gps_idx), w_gps, accumulate=True)
        Hb = Hb + torch.diag_embed(flat)
        gb.index_put_((gps_blk[:, None], gps_idx), w_gps * gr, accumulate=True)
        Hb = Hb + torch.eye(6 * B, dtype=dtype, device=dev) * 1e-6
        H_sep, g_sep, HII_inv_HIS, HII_inv_gI = _eliminate_local(Hb, gb, D, sdim, Pdim)
        H_sep, g_sep = _add_sep_edges(H_sep, g_sep, cross_di, cross_dj, cross_w,
                                 *(ch[k][cre] for k in ("Hii", "Hij", "Hjj", "gi", "gj")))
        H_sep, g_sep = all_sum(H_sep, group), all_sum(g_sep, group)
        H_sep, g_sep = _add_sep_edges(H_sep, g_sep, loop_di, loop_dj, loop_w,
                                 *(lp[k] for k in ("Hii", "Hij", "Hjj", "gi", "gj")))
        H_sep[:6, :6] += anchor
        g_sep[:6] += anchor @ anchor_r
        H_sep = H_sep + torch.eye(Pdim, dtype=dtype, device=dev) * 1e-6
        d_sep = _sep_solve(H_sep, -g_sep[:, None])[:, 0]
        d_sep = torch.cat([d_sep[:6 * P], torch.zeros_like(d_sep[6 * P:])])  # dump slot: nothing
        d_loc = _back_substitute(HII_inv_HIS, HII_inv_gI, d_sep, sdim, D)
        d_n = all_gather_rows(d_loc.reshape(Kn, 6), group).reshape(-1)
        d_n = torch.where(torch.all(torch.isfinite(d_n)), d_n, -gflat)

        # the dogleg trust region: replicated control, summed scalars
        alpha = torch.dot(gflat, gflat) / torch.clamp_min(quad(ch, lp, g_full), 1e-30)
        d_sd = -alpha * gflat
        delta_i = delta
        acc = torch.zeros((), dtype=torch.bool, device=dev)
        d_acc = torch.zeros_like(gflat)
        rho_acc = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(MAX_RADIUS_TRIES):
            dstep = _dogleg_combine(d_n, d_sd, delta_i)
            dm = dstep.reshape(K, 6)
            pred = -(torch.dot(gflat, dstep) + 0.5 * quad(ch, lp, dm))
            chi2_new = chi2_full(R @ lie.so3_exp(dm[:, :3]), p + dm[:, 3:])
            rho = (chi2_cur - chi2_new) / torch.clamp_min(pred, 1e-30)
            acc = (chi2_new < chi2_cur) & (pred > 0) & torch.isfinite(chi2_new)
            if bool(acc):  # equal on every rank: every term was summed
                d_acc, rho_acc = dstep, rho
                break
            delta_i = delta_i * 0.25
        dnorm = torch.linalg.norm(d_acc)
        delta = torch.where(acc & (rho_acc > 0.75), torch.maximum(delta_i, 3.0 * dnorm), delta_i)
        dm = d_acc.reshape(K, 6)
        R = torch.where(acc, R @ lie.so3_exp(dm[:, :3]), R)
        p = torch.where(acc, p + dm[:, 3:], p)

    # the edge-only chi2, as gg.linearize (what the local solver reports)
    chi2 = all_sum(_edge_chi2(R, p, *chain, huber_delta), group) + _edge_chi2(R, p, *loops, huber_delta)
    return dataclasses.replace(g, R=R, p=p), chi2
