"""Sliding-window factor-graph optimizer: dense LM on the stacked window
(port of ``rivslam_tpu/solver/window.py``; radar_graph_slam_nodelet.cpp:
389-472).

The window is W*(6+3+3+3) = W*15 tangent dims, so the sparse block solver
becomes one dense LM. Every factor couples at most the frame pair (i-1, i),
so the Jacobian of slot i's 33-dim residual stack is a [33, 30] block:
``torch.func.jacfwd`` through the retraction of the pair, under
``torch.func.vmap`` over the W slots, and H assembles as a block
tridiagonal. Robust kernels are IRLS weights frozen at each linearization,
as g2o scales by rho'.

The reference runs the solve as nested ``lax.while_loop``s. Here one outer
iteration (``window_iteration``) is a fixed-shape function of a carry
(state, lambda, done): the linearization, then always ``INNER_TRIES`` tries
of the lambda search, each masked by a done flag that freezes the carry
bitwise once a try is accepted or the step falls below 1e-8, as the
reference's inner loop stops there. A carry that enters done leaves
unchanged too. The host runs outer iterations up to
``max_solver_iterations`` and reads one flag per iteration. The LM
bookkeeping (lambda, nu, the accept test, the convergence test) follows the
reference's order, and so does GN's.

On the card the engine replays one outer iteration as a CUDA graph
(``GraphedSolver``), captured once for the window, dtype, configuration and
``use_schur``; the CPU runs ``solve_window`` eagerly.
"""

from __future__ import annotations

import dataclasses

import torch

from rivslam_tpu_torch.core import cuda_graph, lie
from rivslam_tpu_torch.core.config import BackendConfig
from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.factors import preintegration as pre
from rivslam_tpu_torch.factors import residuals, robust

INNER_TRIES = 8  # lambda-search cap (the reference's `j < 8`)
STEP_TOL = 1e-6  # an accepted step below this cannot move the f32 state


@dataclasses.dataclass(frozen=True)
class WindowState:
    """Stacked window of W navigation states."""

    R: torch.Tensor  # [W,3,3]
    p: torch.Tensor  # [W,3]
    v: torch.Tensor  # [W,3]
    bg: torch.Tensor  # [W,3]
    ba: torch.Tensor  # [W,3]

    @property
    def window(self) -> int:
        return self.R.shape[0]

    def astuple(self) -> tuple:
        return (self.R, self.p, self.v, self.bg, self.ba)


@dataclasses.dataclass(frozen=True)
class WindowFactors:
    """All measurements of one window solve. Index i couples frames (i-1, i);
    entries at i=0 or at masked frames are ignored."""

    frame_mask: torch.Tensor  # [W] valid frames
    rel_R: torch.Tensor  # [W,3,3] measurement R of T_i^-1 T_{i-1}
    rel_p: torch.Tensor  # [W,3]
    rel_info: torch.Tensor  # [W,6,6]
    prior_R: torch.Tensor  # [W,3,3] unary scan-match pose prior (odometry)
    prior_p: torch.Tensor  # [W,3]
    prior_info: torch.Tensor  # [W,6,6]
    preint: pre.Preintegration  # stacked [W,...]; entry i integrates (i-1,i)
    preint_info: torch.Tensor  # [W,9,9]
    vel_meas: torch.Tensor  # [W,3] world-frame ego velocity
    vel_info: torch.Tensor  # [W,3] diagonal
    plane_node: torch.Tensor  # [W,4] fixed world plane coeffs
    plane_meas: torch.Tensor  # [W,4] measured local plane
    plane_info: torch.Tensor  # [W] scalar info (1/floor_edge_stddev)
    plane_valid: torch.Tensor  # [W] ground edge present


def _prev(a: torch.Tensor) -> torch.Tensor:
    """Slot i holds entry i-1 (slot 0 wraps around and is masked)."""
    return torch.roll(a, 1, dims=0)


def _lead(tree):
    """Every tensor of a nested tuple with a leading dim of 1."""
    if isinstance(tree, tuple):
        return tuple(_lead(t) for t in tree)
    return tree[None]


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the factorization fails, as XLA's
    is (torch.linalg.cholesky would raise, and read the device to do so)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def retract(x: WindowState, delta: torch.Tensor) -> WindowState:
    """delta [W,15] = (theta, dp, dv, dbg, dba); right-multiplicative on R."""
    return WindowState(*_retract_one(x.astuple(), delta))


def _retract_one(xs, d):
    """Retraction of (R, p, v, bg, ba) by d [..., 15]."""
    R, p, v, bg, ba = xs
    return (
        R @ lie.so3_exp(d[..., 0:3]),
        p + d[..., 3:6],
        v + d[..., 6:9],
        bg + d[..., 9:12],
        ba + d[..., 12:15],
    )


def _slot_blocks(xp, xc, fs):
    """Raw (unwhitened) residuals of the factors of slot i, coupling frames
    (i-1, i), in the reference's order. Batched: it serves one slot under
    vmap and the whole window alike."""
    rel_R, rel_p, prior_R, prior_p, preint, vel_meas, plane_node, plane_meas = fs
    Rp, pp, vp, bgp, bap = xp
    Rc, pc, vc, bgc, bac = xc
    return [
        residuals.bias_rw(bgp, bgc),
        residuals.bias_rw(bap, bac),
        residuals.relative_se3(Rc, pc, Rp, pp, rel_R, rel_p),
        residuals.pose_prior(Rc, pc, prior_R, prior_p),
        residuals.imu_preintegration(Rp, pp, vp, bgp, bap, Rc, pc, vc, pre.Preintegration(*preint)),
        residuals.velocity_prior(vc, vel_meas),
        residuals.se3_plane(Rc, pc, plane_node, plane_meas),
    ]


def _kernels(cfg: BackendConfig):
    """(robust kernel, size) of each block of _slot_blocks."""
    return [
        ("NONE", 1.0),
        ("NONE", 1.0),
        (cfg.odometry_edge_robust_kernel, cfg.odometry_edge_robust_kernel_size),
        (cfg.scan_match_prior_robust_kernel, cfg.scan_match_prior_robust_kernel_size),
        (cfg.integ_edge_robust_kernel, cfg.integ_edge_robust_kernel_size),
        ("NONE", 1.0),
        (cfg.floor_edge_robust_kernel, cfg.floor_edge_robust_kernel_size),
    ]


def _factor_slots(f: WindowFactors):
    return (f.rel_R, f.rel_p, f.prior_R, f.prior_p, f.preint.astuple(), f.vel_meas,
            f.plane_node, f.plane_meas)


def _block_masks(f: WindowFactors, dtype) -> torch.Tensor:
    """[W, 7] 0/1 mask of each block: both frames valid, slot 0 never."""
    edge = f.frame_mask & _prev(f.frame_mask)
    edge = torch.cat([torch.zeros_like(edge[:1]), edge[1:]])
    return torch.stack([edge] * 6 + [edge & f.plane_valid], dim=1).to(dtype)


def whiten_cache(f: WindowFactors, bias_info, window: int, dtype):
    """Per-block whitening factors, built once per solve: sqrt of a diagonal
    info, or the Cholesky L of a matrix info (whitened r = L^T r)."""
    bg_info, ba_info = bias_info
    dev = f.rel_info.device

    def chol(info):
        return _cholesky(info + 1e-12 * torch.eye(info.shape[-1], dtype=info.dtype, device=dev))

    return (
        torch.full((window, 3), max(bg_info, 0.0) ** 0.5, dtype=dtype, device=dev),
        torch.full((window, 3), max(ba_info, 0.0) ** 0.5, dtype=dtype, device=dev),
        chol(f.rel_info),
        chol(f.prior_info),
        chol(f.preint_info),
        torch.sqrt(torch.clamp_min(f.vel_info, 0.0)),
        torch.sqrt(torch.clamp_min(f.plane_info, 0.0))[:, None] * torch.ones(3, dtype=dtype, device=dev),
    )


def _apply_whiten(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Elementwise for diagonal-sqrt factors, L^T r for Cholesky factors."""
    if c.ndim == r.ndim:
        return c * r
    return torch.einsum("...ji,...j->...i", c, r)


def residual_vector(x: WindowState, f: WindowFactors, cfg: BackendConfig, bias_info,
                    kernel_weights=None, cache=None):
    """Flat whitened robust-weighted residual vector, plus the kernel weights
    used (so a linearization can freeze them, IRLS-style)."""
    xs = x.astuple()
    blocks = _slot_blocks(tuple(_prev(a) for a in xs), xs, _factor_slots(f))
    if cache is None:
        cache = whiten_cache(f, bias_info, x.window, x.p.dtype)
    masks = _block_masks(f, x.p.dtype)
    flat, weights = [], []
    for k, (r, (kname, ksize)) in enumerate(zip(blocks, _kernels(cfg))):
        w = _apply_whiten(r, cache[k])
        if kernel_weights is not None:
            kw = kernel_weights[k]
        else:
            kw = robust.kernel_weight(kname, ksize, torch.sum(w * w, dim=-1))
        weights.append(kw)
        flat.append((w * (torch.sqrt(kw) * masks[:, k])[:, None]).reshape(-1))
    return torch.cat(flat), weights


def linearize_blocks(x: WindowState, f: WindowFactors, cfg: BackendConfig,
                     bias_info, kernel_weights, cache=None):
    """Block-structured linearization: per slot, jacfwd of its 33 whitened
    residuals over the pair's 30 tangent dims, vmapped over W; then the
    block-tridiagonal H and the gradient. Kernel weights are frozen.

    Returns (H [W15, W15], g [W15], chi2)."""
    W = x.window
    dtype = x.p.dtype
    if cache is None:
        cache = whiten_cache(f, bias_info, W, dtype)
    masks = _block_masks(f, dtype)
    kws = torch.stack(list(kernel_weights), dim=1)  # [W, 7]
    xs = x.astuple()
    xp = tuple(_prev(a) for a in xs)

    def slot_r(d, xp1, xc1, fs1, c1, kw1, m1):
        # one slot, carried with a leading dim of 1: under jacfwd a 0-dim
        # dual tensor times a Python float comes out float64 (torch 2.13),
        # and the slot's scalars (angles, dt) would be 0-dim
        xp1, xc1, fs1, d = _lead(xp1), _lead(xc1), _lead(fs1), d[None]
        blocks = _slot_blocks(_retract_one(xp1, d[:, :15]), _retract_one(xc1, d[:, 15:]), fs1)
        return torch.cat([
            _apply_whiten(r, c1[k][None]) * (torch.sqrt(kw1[k]) * m1[k]) for k, r in enumerate(blocks)
        ], dim=-1)[0]

    def slot_rj(xp1, xc1, fs1, c1, kw1, m1):
        z = torch.zeros(30, dtype=dtype, device=kw1.device)
        r0 = slot_r(z, xp1, xc1, fs1, c1, kw1, m1)
        J = torch.func.jacfwd(slot_r)(z, xp1, xc1, fs1, c1, kw1, m1)  # [33, 30]
        return r0, J

    r0, J = torch.func.vmap(slot_rj)(xp, xs, _factor_slots(f), cache, kws, masks)
    Jp, Jc = J[:, :, :15], J[:, :, 15:]
    Hpp = torch.einsum("wri,wrj->wij", Jp, Jp)
    Hcc = torch.einsum("wri,wrj->wij", Jc, Jc)
    Hpc = torch.einsum("wri,wrj->wij", Jp, Jc)
    gp = torch.einsum("wri,wr->wi", Jp, r0)
    gc = torch.einsum("wri,wr->wi", Jc, r0)
    # one-hot assembly: Ec[w] selects column block w, Ep[w] block w-1
    Ec = torch.eye(W, dtype=dtype, device=J.device)
    Ep = _prev(Ec)
    H = (
        torch.einsum("wij,wa,wb->aibj", Hcc, Ec, Ec)
        + torch.einsum("wij,wa,wb->aibj", Hpp, Ep, Ep)
        + torch.einsum("wij,wa,wb->aibj", Hpc, Ep, Ec)
        + torch.einsum("wji,wa,wb->aibj", Hpc, Ec, Ep)
    ).reshape(W * 15, W * 15)
    g = (torch.einsum("wi,wa->ai", gc, Ec) + torch.einsum("wi,wa->ai", gp, Ep)).reshape(W * 15)
    return H, g, torch.sum(r0 * r0)


def _damped_solve(A, rhs):
    """Jacobi-equilibrated Cholesky solve of the SPD damped system. A failed
    factorization gives NaN, which the LM accept test rejects."""
    d = torch.diagonal(A)
    floor = 1e-12 * torch.max(torch.abs(d)) + 1e-30
    s = torch.rsqrt(torch.maximum(torch.abs(d), floor))
    L = _cholesky(A * s[:, None] * s[None, :])
    y = torch.linalg.solve_triangular(L, (rhs * s)[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x[:, 0] * s


def _schur_solve(H, g, lam, W, dtype):
    """Damped solve by Schur elimination of the velocity/bias blocks; the
    same solution as the full damped solve."""
    idx = torch.arange(W * 15, device=H.device).reshape(W, 15)
    p_idx = idx[:, :6].reshape(-1)
    r_idx = idx[:, 6:].reshape(-1)
    A = H + lam * torch.eye(W * 15, dtype=dtype, device=H.device)
    App = A[p_idx][:, p_idx]
    Apr = A[p_idx][:, r_idx]
    Arr = A[r_idx][:, r_idx]
    gp, gr = g[p_idx], g[r_idx]
    Arr_inv_gr = torch.linalg.solve_ex(Arr, gr[:, None])[0][:, 0]
    Arr_inv_Arp = torch.linalg.solve_ex(Arr, Apr.T)[0]
    S = App - Apr @ Arr_inv_Arp
    dp = torch.linalg.solve_ex(S, -(gp - Apr @ Arr_inv_gr)[:, None])[0][:, 0]
    dr = -Arr_inv_gr - Arr_inv_Arp @ dp
    d = torch.zeros(W * 15, dtype=dtype, device=H.device)
    return d.index_put((p_idx,), dp).index_put((r_idx,), dr)


def _select(c: torch.Tensor, a: WindowState, b: WindowState) -> WindowState:
    return WindowState(*(torch.where(c, u, v) for u, v in zip(a.astuple(), b.astuple())))


def _rel_tol(dtype) -> float:
    """Relative chi2 gain below this, or a step below STEP_TOL, converges."""
    return 1e-5 if dtype == torch.float32 else 1e-9


def chi2_of(x: WindowState, f: WindowFactors, cfg: BackendConfig, bias_info, cache, kw=None):
    r, _ = residual_vector(x, f, cfg, bias_info, kw, cache=cache)
    return torch.sum(r * r)


def initial_carry(x0: WindowState, cfg: BackendConfig) -> tuple:
    """(R, p, v, bg, ba, lam, done) before the first outer iteration: LM's
    lambda starts unset (-1, set from H at the first linearization), GN's
    damping at 0."""
    lam = torch.full((), 0.0 if cfg.optimizer == "GN" else -1.0, dtype=x0.p.dtype, device=x0.p.device)
    return (*x0.astuple(), lam, torch.zeros((), dtype=torch.bool, device=x0.p.device))


def window_iteration(carry: tuple, f: WindowFactors, cfg: BackendConfig, bias_info, cache,
                     use_schur: bool = False) -> tuple:
    """One outer LM (or GN) iteration of the reference's ``while_loop``
    body, with no host read: returns the next carry (R, p, v, bg, ba, lam,
    done). A carry that enters done comes out bitwise unchanged."""
    *xs, lam_in, done_in = carry
    x = WindowState(*xs)
    W = x.window
    dtype = x.p.dtype
    REL_TOL = _rel_tol(dtype)
    _, kw = residual_vector(x, f, cfg, bias_info, cache=cache)
    H, g, y0 = linearize_blocks(x, f, cfg, bias_info, kw, cache=cache)

    def step(lam):
        if use_schur:
            return _schur_solve(H, g, lam, W, dtype)
        return _damped_solve(H + lam * torch.eye(W * 15, dtype=dtype, device=H.device), -g)

    if cfg.optimizer == "GN":
        # one (near-)undamped step per linearization; a rejected step
        # escalates the damping 100x and retries, up to LAM_MAX
        LAM_MAX = 1e6
        lam = lam_in
        eps = torch.clamp_min(lam, 1e-8) * torch.clamp_min(torch.max(torch.abs(torch.diagonal(H))), 1.0)
        d = step(eps)
        x_new = retract(x, d.reshape(W, 15))
        y1 = chi2_of(x_new, f, cfg, bias_info, cache, kw)
        accept = y1 < y0
        x_next = _select(accept, x_new, x)
        converged = (
            (accept & (torch.abs(y0 - y1) < REL_TOL * torch.clamp_min(y0, 1.0)))
            | (accept & (torch.max(torch.abs(d)) < STEP_TOL))
            | (~accept & (lam >= LAM_MAX))
        )
        lam_next = torch.where(accept, torch.clamp_min(lam / 10.0, 0.0), torch.clamp_min(lam, 1e-8) * 100.0)
        done_next = converged
    else:
        lam = torch.where(lam_in < 0, 1e-5 * torch.max(torch.abs(torch.diagonal(H))), lam_in)
        x_i, nu = x, torch.full((), 2.0, dtype=dtype, device=H.device)
        idone = torch.zeros((), dtype=torch.bool, device=H.device)
        success = torch.zeros((), dtype=torch.bool, device=H.device)
        dmax = torch.full((), torch.inf, dtype=dtype, device=H.device)
        y_new = y0
        for _ in range(INNER_TRIES):
            # every try runs; one past done changes nothing (the reference's
            # inner while_loop stops at an accepted or vanishing step)
            d = step(lam)
            x_new = retract(x, d.reshape(W, 15))
            y1 = chi2_of(x_new, f, cfg, bias_info, cache, kw)
            denom = torch.dot(d, lam * d - g)
            rho = (y0 - y1) / torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
            accept = (rho > 0) & (y1 < y0)
            live = ~idone
            take = live & accept
            lam_new = torch.where(
                accept,
                lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0),
                lam * nu,
            )
            lam = torch.where(live, lam_new, lam)
            x_i = _select(take, x_new, x_i)
            nu = torch.where(live & ~accept, 2.0 * nu, nu)
            success = torch.where(live, accept, success)
            dmax = torch.where(take, torch.max(torch.abs(d)), dmax)
            y_new = torch.where(take, y1, y_new)
            idone = idone | accept | (torch.linalg.norm(d) < 1e-8)
        converged = success & (
            (torch.abs(y0 - y_new) < REL_TOL * torch.clamp_min(y0, 1.0)) | (dmax < STEP_TOL)
        )
        x_next, lam_next, done_next = x_i, lam, converged | ~success
    out = _select(done_in, x, x_next).astuple()
    return (*out, torch.where(done_in, lam_in, lam_next), done_in | done_next)


def solve_window(
    x0: WindowState,
    f: WindowFactors,
    cfg: BackendConfig,
    bias_info: tuple[float, float],
    use_schur: bool = False,
) -> tuple[WindowState, torch.Tensor, int]:
    """LM (or GN) to convergence within the iteration cap, eagerly. Returns
    (state, chi2, iterations)."""
    cache = whiten_cache(f, bias_info, x0.window, x0.p.dtype)
    carry = initial_carry(x0, cfg)
    it = 0
    while it < cfg.max_solver_iterations:
        carry = window_iteration(carry, f, cfg, bias_info, cache, use_schur)
        it += 1
        if bool(carry[-1]):  # one host read per outer iteration
            break
    x = WindowState(*carry[:5])
    return x, chi2_of(x, f, cfg, bias_info, cache), it


def _factor_fields(f: WindowFactors) -> list[torch.Tensor]:
    out = []
    for fld in dataclasses.fields(f):
        v = getattr(f, fld.name)
        out.extend(v.astuple() if isinstance(v, pre.Preintegration) else [v])
    return out


def _factors_from(fields: list[torch.Tensor]) -> WindowFactors:
    names = [fld.name for fld in dataclasses.fields(WindowFactors)]
    n_pre = len(dataclasses.fields(pre.Preintegration))
    k = names.index("preint")
    vals = fields[:k] + [pre.Preintegration(*fields[k:k + n_pre])] + fields[k + n_pre:]
    return WindowFactors(**dict(zip(names, vals)))


def _placeholder(window: int, dtype, device) -> tuple[WindowState, WindowFactors]:
    """A well-posed window of the given shape (identity poses, unit
    information) for the capture's warm-up; its values are never used."""
    kw = dict(dtype=dtype, device=device)
    W = window

    def eye(n):
        return torch.eye(n, **kw).expand(W, n, n).clone()

    def zeros(*shape):
        return torch.zeros((W,) + shape, **kw)

    p_id = pre.Preintegration.identity(dtype, device)
    preint = pre.Preintegration(*(a.expand((W,) + a.shape).clone() for a in p_id.astuple()))
    f = WindowFactors(
        frame_mask=torch.ones(W, dtype=torch.bool, device=device),
        rel_R=eye(3), rel_p=zeros(3), rel_info=eye(6), prior_R=eye(3), prior_p=zeros(3),
        prior_info=eye(6), preint=preint, preint_info=eye(9), vel_meas=zeros(3),
        vel_info=torch.ones((W, 3), **kw),
        plane_node=torch.tensor([0.0, 0.0, 1.0, 0.0], **kw).expand(W, 4).clone(),
        plane_meas=torch.tensor([0.0, 0.0, 1.0, 0.0], **kw).expand(W, 4).clone(),
        plane_info=torch.ones(W, **kw), plane_valid=torch.ones(W, dtype=torch.bool, device=device),
    )
    x = WindowState(R=eye(3), p=zeros(3), v=zeros(3), bg=zeros(3), ba=zeros(3))
    return x, f


class GraphedSolver:
    """``solve_window`` on the card for one fixed window, dtype,
    configuration and ``use_schur``, as two CUDA graphs over shared static
    inputs (the carry, the factors and their whitening cache), captured at
    construction: one outer iteration (``window_iteration``: the
    linearization with ``jacfwd`` under ``vmap`` and the INNER_TRIES masked
    tries), which writes its next carry back into its inputs, and the final
    chi2. A solve copies x0, the factors and the cache into the inputs,
    replays the iteration until its done flag reads true (one host read per
    iteration, at most ``max_solver_iterations``), then replays the chi2."""

    def __init__(self, cfg: BackendConfig, bias_info, window: int, dtype, device,
                 use_schur: bool = False):
        self.cfg, self.bias_info, self.window, self.use_schur = cfg, bias_info, window, use_schur
        x0, f0 = _placeholder(window, dtype, device)
        cache0 = whiten_cache(f0, bias_info, window, dtype)
        self._n_fac = len(_factor_fields(f0))
        inputs = [t.clone() for t in (*initial_carry(x0, cfg), *_factor_fields(f0), *cache0)]
        self._carry = inputs[:7]

        def unpack(args):
            carry = args[:7]
            f = _factors_from(list(args[7:7 + self._n_fac]))
            return carry, f, tuple(args[7 + self._n_fac:])

        def iteration(*args):
            carry, f, cache = unpack(args)
            new = window_iteration(carry, f, cfg, bias_info, cache, use_schur)
            for dst, src in zip(carry, new):
                dst.copy_(src)
            return ()

        def final_chi2(*args):
            carry, f, cache = unpack(args)
            return (chi2_of(WindowState(*carry[:5]), f, cfg, bias_info, cache),)

        self._iteration = cuda_graph.Graphed("window_iteration", iteration, inputs)
        self._chi2 = cuda_graph.Graphed("window_chi2", final_chi2, inputs)

    @property
    def replays(self) -> int:
        return self._iteration.replays + self._chi2.replays

    def __call__(self, x0: WindowState, f: WindowFactors) -> tuple[WindowState, torch.Tensor, int]:
        if x0.window != self.window:
            raise ValueError(f"window of {x0.window} slots, but the graph was captured for {self.window}")
        with timing.span("window_solve.load"):
            cache = whiten_cache(f, self.bias_info, self.window, x0.p.dtype)
            self._iteration.load(*initial_carry(x0, self.cfg), *_factor_fields(f), *cache)
        done = self._carry[-1]
        it = 0
        while it < self.cfg.max_solver_iterations:
            with timing.span("window_solve.replay"):
                self._iteration.replay()
            it += 1
            with timing.span("window_solve.done_read"):
                finished = bool(done)  # one host read per outer iteration
            if finished:
                break
        with timing.span("window_solve.chi2"):
            (chi2,) = self._chi2.replay()
            return WindowState(*(t.clone() for t in self._carry[:5])), chi2.clone(), it
