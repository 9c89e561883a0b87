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
unchanged too. ``solve_window`` runs outer iterations up to
``max_solver_iterations``, reading one flag per iteration. The LM
bookkeeping (lambda, nu, the accept test, the convergence test) follows the
reference's order, and so does GN's.

On the card the whole solve is one launch of a hand-written kernel
(``csrc/window_lm.cu``: a thread block per window, the same linearization
by dual numbers, a banded Cholesky for the damped system, with or without
``use_schur``, and the same bookkeeping; tries and iterations whose outcome
is known are not run). ``solve`` launches it for CUDA tensors and runs
``solve_window``, its plain twin, for CPU tensors; ``FusedSolver`` is the
Engine's, with its launches counted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.config import BackendConfig
from rivslam_tpu_torch.core.navstate import GRAVITY
from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.factors import preintegration as pre
from rivslam_tpu_torch.factors import residuals, robust
from rivslam_tpu_torch.ops import cuda_build

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
                     use_schur: bool = False) -> tuple[tuple, torch.Tensor]:
    """One outer LM (or GN) iteration of the reference's ``while_loop``
    body, with no host read: returns the next carry (R, p, v, bg, ba, lam,
    done), which a carry that enters done leaves bitwise unchanged, and the
    count of live lambda tries (0-dim: GN's one step, LM's tries up to and
    with the one that ended the search; 0 for a carry that enters done)."""
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
        tries = torch.ones((), dtype=torch.int64, device=H.device)
    else:
        lam = torch.where(lam_in < 0, 1e-5 * torch.max(torch.abs(torch.diagonal(H))), lam_in)
        x_i, nu = x, torch.full((), 2.0, dtype=dtype, device=H.device)
        idone = torch.zeros((), dtype=torch.bool, device=H.device)
        success = torch.zeros((), dtype=torch.bool, device=H.device)
        dmax = torch.full((), torch.inf, dtype=dtype, device=H.device)
        y_new = y0
        tries = torch.zeros((), dtype=torch.int64, device=H.device)
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
            tries = tries + live.to(torch.int64)
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
    return (*out, torch.where(done_in, lam_in, lam_next), done_in | done_next), torch.where(done_in, 0, tries)


def solve_window(
    x0: WindowState,
    f: WindowFactors,
    cfg: BackendConfig,
    bias_info: tuple[float, float],
    use_schur: bool = False,
) -> tuple[WindowState, torch.Tensor, int, int]:
    """LM (or GN) to convergence within the iteration cap, eagerly: the
    kernel's plain twin. Returns (state, chi2, iterations, lambda tries)."""
    cache = whiten_cache(f, bias_info, x0.window, x0.p.dtype)
    carry = initial_carry(x0, cfg)
    it, tries = 0, 0
    while it < cfg.max_solver_iterations:
        carry, n = window_iteration(carry, f, cfg, bias_info, cache, use_schur)
        tries = tries + n
        it += 1
        if bool(carry[-1]):  # one host read per outer iteration
            break
    x = WindowState(*carry[:5])
    return x, chi2_of(x, f, cfg, bias_info, cache), it, int(tries)


# ---- the kernel (csrc/window_lm.cu) ------------------------------------------

SOURCE = os.path.join(cuda_build.CSRC, "window_lm.cu")
KERNELS = ("NONE", "Huber", "Cauchy", "GemanMcClure", "Welsch", "Fair", "DCS", "Saturated", "Tukey",
           "PseudoHuber")  # robust.kernel_weight's kernels, by the kernel's id
DTYPES = (torch.float32, torch.float64)

_build: cuda_build.Build | None = None


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.rivslam_window_lm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("rivslam_window_lm_max_window", "rivslam_window_lm_slot_elems"):
        getattr(lib, name).restype = ctypes.c_int
    lib.rivslam_window_lm_max_window.argtypes = [ctypes.c_int]


def build() -> cuda_build.Build:
    """Compile (once per source hash) and load the kernel library."""
    global _build
    if _build is None:
        _build = cuda_build.build(SOURCE, _declare)
    return _build


@functools.cache
def max_window(dtype) -> int:
    """The most slots a window of ``dtype`` may have: what fits the block's
    shared memory, as the kernel's library reports it (its layout lives in
    the source alone; this builds the library)."""
    return build().lib.rivslam_window_lm_max_window(int(dtype == torch.float64))


def _inputs(x: WindowState, f: WindowFactors) -> list[torch.Tensor]:
    """The kernel's inputs in its order (``In`` in the source)."""
    p = f.preint
    return [*x.astuple(), f.frame_mask, f.rel_R, f.rel_p, f.rel_info, f.prior_R, f.prior_p, f.prior_info,
            p.dt, p.dR, p.dv, p.dp, p.dR_dbg, p.dV_dbg, p.dV_dba, p.dP_dbg, p.dP_dba, p.bg, p.ba,
            f.preint_info, f.vel_meas, f.vel_info, f.plane_node, f.plane_meas, f.plane_info, f.plane_valid]


def check(x: WindowState, f: WindowFactors) -> tuple[int, int]:
    """Raise on what the kernel cannot take: a dtype other than float32 or
    float64, inputs of mixed dtypes, devices or shapes, an empty window.
    Every field carries a leading [B]. Returns (B, W). The most slots the
    kernel's shared memory holds is ``max_window``, checked at the launch."""
    dtype = x.p.dtype
    if dtype not in DTYPES:
        raise ValueError(f"the window kernel takes float32 or float64, got {dtype}")
    if x.p.ndim != 3 or x.p.shape[-1] != 3:
        raise ValueError(f"state p must be [B, W, 3], got {tuple(x.p.shape)}")
    B, W = x.p.shape[:2]
    if W < 1:
        raise ValueError("the window has no slot")
    for t in _inputs(x, f):
        want = torch.bool if t is f.frame_mask or t is f.plane_valid else dtype
        if t.dtype != want:
            raise ValueError(f"window inputs must be {dtype} (masks bool), got {t.dtype}")
        if t.device != x.p.device or tuple(t.shape[:2]) != (B, W):
            raise ValueError(f"window inputs must be [B={B}, W={W}, ...] on {x.p.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    return B, W


def _params(cfg: BackendConfig, bias_info, dtype):
    """The kernel's scalar parameters: (double array, int array)."""
    kernels = _kernels(cfg)
    for name, _ in kernels:
        if name not in KERNELS:
            raise ValueError(f"unknown robust kernel {name}")
    bg_info, ba_info = bias_info
    dp = (ctypes.c_double * 11)(*(float(size) for _, size in kernels), max(bg_info, 0.0) ** 0.5,
                                max(ba_info, 0.0) ** 0.5, GRAVITY, _rel_tol(dtype))
    ip = (ctypes.c_int * 9)(*(KERNELS.index(name) for name, _ in kernels), int(cfg.optimizer == "GN"),
                            int(cfg.max_solver_iterations))
    return dp, ip


def solve_batched(x: WindowState, f: WindowFactors, cfg: BackendConfig, bias_info,
                  params=None) -> tuple[WindowState, torch.Tensor, torch.Tensor]:
    """One launch of the kernel over B windows (every field [B, W, ...], on
    the card). Returns (states, chi2 [B], counts [B, 2] int32: outer
    iterations and lambda tries), on the device, unread. ``use_schur``
    needs no argument: the banded factorization serves both settings."""
    B, W = check(x, f)
    dev, dtype = x.p.device, x.p.dtype
    if dev.type != "cuda":
        raise ValueError(f"the window kernel runs on CUDA tensors, got {dev}")
    if W > max_window(dtype):
        raise ValueError(f"window of {W} slots: the kernel takes 1..{max_window(dtype)} in {dtype}")
    dp, ip = _params(cfg, bias_info, dtype) if params is None else params
    ins = [t.contiguous() for t in _inputs(x, f)]
    out = torch.empty(B * W * 21 + B, dtype=dtype, device=dev)
    sizes = (9, 3, 3, 3, 3)
    parts = torch.split(out, [B * W * n for n in sizes] + [B])
    counts = torch.empty((B, 2), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    outs = (ctypes.c_void_p * 7)(*(t.data_ptr() for t in parts), counts.data_ptr())
    cuda_build.launch(build().lib.rivslam_window_lm, dev, ptrs, outs, dp, ip, B, W,
                      int(dtype == torch.float64))
    cuda_build.count_launch(solve_batched)
    states = WindowState(parts[0].view(B, W, 3, 3), *(t.view(B, W, 3) for t in parts[1:5]))
    return states, parts[5], counts


solve_batched.launches = 0  # kernel launches, but for the loop worker's
solve_batched.worker_launches = 0  # those of the loop worker's thread


def _lead1(obj):
    """Every tensor of a state or factors with a leading [1] (a view)."""
    kw = {}
    for fld in dataclasses.fields(obj):
        v = getattr(obj, fld.name)
        kw[fld.name] = _lead1(v) if dataclasses.is_dataclass(v) else v[None]
    return type(obj)(**kw)


def solve(x0: WindowState, f: WindowFactors, cfg: BackendConfig, bias_info, use_schur: bool = False,
          params=None) -> tuple[WindowState, torch.Tensor, int, int]:
    """The window solve: one kernel launch and one host read (the
    iteration and try counts) for CUDA tensors, ``solve_window`` for CPU
    tensors. Counts the tracer's ``lm_iterations`` and ``lm_tries`` under
    the span open around the call. ``params``: the kernel's, made once by
    ``_params``. Returns (state, chi2, iterations, lambda tries)."""
    dev = x0.p.device
    if dev.type == "cpu":
        x, chi2, it, tries = solve_window(x0, f, cfg, bias_info, use_schur)
    elif dev.type == "cuda":
        with timing.span("window_solve.launch"):
            xb, chi2b, counts = solve_batched(_lead1(x0), _lead1(f), cfg, bias_info, params)
        with timing.span("window_solve.read"):
            it, tries = counts[0].tolist()
        x, chi2 = WindowState(*(t[0] for t in xb.astuple())), chi2b[0]
    else:
        raise ValueError(f"unsupported device {dev}")
    timing.count("lm_iterations", n=it)
    timing.count("lm_tries", n=tries)
    return x, chi2, it, tries


class FusedSolver:
    """``solve`` for one configuration and bias information, its kernel
    parameters made once. ``replays`` counts its launches (one a solve on
    the card, none on the CPU); ``iterations`` and ``tries`` add up its
    solves' outer iterations and lambda tries."""

    def __init__(self, cfg: BackendConfig, bias_info, dtype):
        self.cfg, self.bias_info = cfg, tuple(bias_info)
        self._params = _params(cfg, self.bias_info, dtype) if dtype in DTYPES else None
        self.replays = self.iterations = self.tries = 0

    def __call__(self, x0: WindowState, f: WindowFactors) -> tuple[WindowState, torch.Tensor, int, int]:
        x, chi2, it, tries = solve(x0, f, self.cfg, self.bias_info, self.cfg.use_schur, self._params)
        self.replays += x0.p.device.type == "cuda"
        self.iterations += it
        self.tries += tries
        return x, chi2, it, tries
