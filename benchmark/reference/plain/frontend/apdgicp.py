"""APDGICP scan registration (port of ``rivslam_tpu/frontend/apdgicp.py``),
cut to what the check's control runs: ``prepare`` and ``register_dispatch``
on the fast (structure-of-arrays) path, ``frontend/apdgicp_fast.py``, for
PLANE covariances and FAST_APDGICP / FAST_GICP / GICP / GICP_OMP with
``use_fast_path``, as every configuration of the benchmark sets them.

The port batches over a leading problem dim B where the reference vmaps;
``prepare`` and ``register_dispatch`` also take a single unbatched problem
and then return unbatched results. The LM/GN loop: the reference's nested
``lax.while_loop``s become fixed-count functions of tensors over all B
problems with per-problem done masks. ``lm_iteration`` is one outer
iteration (the linearization, then always ``lm_max_iterations`` lambda
tries, ``lm_try``); a try or an iteration past done leaves that problem's
state bitwise unchanged, so B problems give what B separate reference calls
give. ``solve_lm`` runs the iterations eagerly and reads one flag from the
device after each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.plain.core import lie
from benchmark.reference.plain.core.config import RegistrationConfig
from benchmark.reference.plain.core.device import resolve

_FAST_METHODS = ("FAST_APDGICP", "FAST_GICP", "GICP", "GICP_OMP")


@dataclasses.dataclass(frozen=True)
class PreparedCloud:
    """A cloud with precomputed regularized GICP covariances."""

    xyz: torch.Tensor  # [B, N, 3]
    mask: torch.Tensor  # [B, N]
    cov: torch.Tensor  # [B, N, 3, 3]


@dataclasses.dataclass(frozen=True)
class RegistrationResult:
    T: torch.Tensor  # [B, 4, 4] final source->target transform
    H: torch.Tensor  # [B, 6, 6] final Hessian (information of the estimate)
    error: torch.Tensor  # [B] final weighted error
    converged: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32 outer iterations used
    num_correspondences: torch.Tensor  # [B] int32 at the final linearization
    fitness: torch.Tensor  # [B] mean NN sq distance over matched points


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))).to(dev)


def _map(obj, fn):
    return type(obj)(**{f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _is_converged(delta_T: torch.Tensor, cfg: RegistrationConfig) -> torch.Tensor:
    """lsq_registration_impl.hpp:83-92, batched over leading dims."""
    eye = torch.eye(3, dtype=delta_T.dtype, device=delta_T.device)
    R = delta_T[..., :3, :3] - eye
    t = delta_T[..., :3, 3]
    r_delta = torch.amax(torch.abs(R), dim=(-2, -1)) / cfg.rotation_epsilon
    t_delta = torch.amax(torch.abs(t), dim=-1) / cfg.transformation_epsilon
    return torch.maximum(r_delta, t_delta) < 1.0


def _se3_step(d: torch.Tensor) -> torch.Tensor:
    """[B, 6] step [w, t] -> 4x4 with R = exp(w), translation t (NOT
    se3_exp's coupled translation; lsq_registration_impl.hpp:140-143)."""
    return lie.se3_matrix(lie.so3_exp(d[:, :3]), d[:, 3:])


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-problem [B] condition broadcast over trailing dims."""
    return torch.where(c.reshape(c.shape + (1,) * (a.ndim - 1)), a, b)


def _solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    # solve_ex: a singular system (a problem without correspondences) yields
    # inf/nan like the reference's LU solve instead of raising
    return torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]


def lm_init(T0: torch.Tensor, cfg: RegistrationConfig) -> tuple:
    """The LM/GN carry before the first outer iteration: (T [B,4,4], lambda
    [B] (-1: unset, taken from H at the first linearization), converged,
    failed [B] bool, iterations [B] int32, H at the last accepted step
    [B,6,6])."""
    dtype, dev = T0.dtype, T0.device
    B = T0.shape[0]
    return (
        T0.clone(),
        torch.full((B,), -1.0, dtype=dtype, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.eye(6, dtype=dtype, device=dev).expand(B, 6, 6).clone(),
    )


def lm_active(carry: tuple, cfg: RegistrationConfig) -> torch.Tensor:
    """[B] problems that still iterate: neither converged nor failed, and
    under the iteration cap."""
    _, _, converged, failed, it, _ = carry
    return ~converged & ~failed & (it < cfg.max_iterations)


def lm_try(tries: tuple, H, b, y0, T, ctx, cfg: RegistrationConfig, error_at) -> tuple:
    """One try of the lambda search (lsq_registration_impl.hpp:125-173) over
    the tries' state (T_i, lam_i, nu, done, success, conv_i, dlast). A
    problem whose search is done (a try accepted, or the rejected step
    converged) comes out bitwise unchanged."""
    T_i, lam_i, nu, done, success, conv_i, dlast = tries
    run = ~done
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    d = _solve(H + lam_i[:, None, None] * eye6, -b)
    delta = _se3_step(d)
    T_new = delta @ T
    yi = error_at(T_new, ctx)
    denom = torch.sum(d * (lam_i[:, None] * d - b), dim=-1)
    rho = (y0 - yi) / torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    accept = rho >= 0.0
    conv_rej = _is_converged(delta, cfg)
    grow = torch.clamp_min(1 - (2 * rho - 1) ** 3, 1 / 3)
    return (
        _where(run & accept, T_new, T_i),
        torch.where(run, torch.where(accept, lam_i * grow, nu * lam_i), lam_i),
        torch.where(run & ~accept, 2 * nu, nu),
        torch.where(run, accept | conv_rej, done),
        torch.where(run, accept, success),
        torch.where(run, conv_rej & ~accept, conv_i),
        _where(run & accept, delta, dlast),
    )


def lm_iteration(carry: tuple, cfg: RegistrationConfig, linearize_at, error_at) -> tuple:
    """One outer LM (or GN) iteration over B problems with no host read:
    ``linearize_at(T) -> (H [B,6,6], b [B,6], y0 [B], ctx)`` fixes the
    correspondences at T, ``error_at(T, ctx) -> [B]`` is the error under
    them. LM always runs ``cfg.lm_max_iterations`` tries (``lm_try``); a
    problem that is not active (``lm_active``) comes out bitwise unchanged.
    Returns the next carry (``lm_init``)."""
    T, lam, converged, failed, it, Hf = carry
    active = lm_active(carry, cfg)
    H, b, y0, ctx = linearize_at(T)
    if cfg.optimizer == "GN":
        # step_gn (lsq_registration_impl.hpp:107-123): one undamped solve
        delta = _se3_step(_solve(H, -b))
        return (
            _where(active, delta @ T, T), lam,
            torch.where(active, _is_converged(delta, cfg), converged), failed,
            it + active.to(torch.int32), _where(active, H, Hf),
        )

    B = T.shape[0]
    diag_max = torch.amax(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)), dim=-1)
    lam_i = torch.where(lam < 0, cfg.lm_init_lambda_factor * diag_max, lam)
    done = ~active
    tries = (
        T, lam_i, torch.full((B,), 2.0, dtype=T.dtype, device=T.device), done,
        torch.zeros_like(done), torch.zeros_like(done),
        torch.eye(4, dtype=T.dtype, device=T.device).expand(B, 4, 4),
    )
    for _ in range(cfg.lm_max_iterations):
        tries = lm_try(tries, H, b, y0, T, ctx, cfg, error_at)
    T_i, lam_i, _, _, success, conv_i, dlast = tries
    return (
        _where(active, T_i, T),
        torch.where(active, lam_i, lam),
        torch.where(active, torch.where(success, _is_converged(dlast, cfg), conv_i), converged),
        torch.where(active, ~success & ~conv_i, failed),
        it + active.to(torch.int32),
        _where(active & success, H, Hf),
    )


def solve_lm(T0: torch.Tensor, cfg: RegistrationConfig, linearize_at, error_at):
    """The LsqRegistration LM/GN loop (lsq_registration_impl.hpp:55-173)
    over B problems, eagerly: ``lm_iteration`` up to ``cfg.max_iterations``
    times, reading one flag from the device after each (whether any problem
    is still active). Returns (T, H at the last accepted step, converged,
    iterations)."""
    carry = lm_init(T0, cfg)
    for i in range(cfg.max_iterations):
        carry = lm_iteration(carry, cfg, linearize_at, error_at)
        if i + 1 < cfg.max_iterations and not bool(lm_active(carry, cfg).any()):
            break
    T, _, converged, _, it, Hf = carry
    return T, Hf, converged, it


def run_registration(model, problem: tuple, T0: torch.Tensor, cfg: RegistrationConfig) -> RegistrationResult:
    """``solve_lm`` and the final correspondence statistics of one
    registration. ``model(*problem, cfg) -> (linearize_at, error_at,
    final_at)`` builds the path's functions over its fixed inputs
    ``problem`` (tensors); ``final_at(T) -> (error, correspondences,
    fitness)``."""
    linearize_at, error_at, final_at = model(*problem, cfg)
    T, Hf, converged, it = solve_lm(T0, cfg, linearize_at, error_at)
    error, ncorr, fitness = final_at(T)
    return RegistrationResult(
        T=T, H=Hf, error=error, converged=converged, iterations=it,
        num_correspondences=ncorr, fitness=fitness,
    )


def _fast_path(cfg: RegistrationConfig) -> None:
    if not (cfg.use_fast_path and cfg.regularization == "PLANE" and cfg.method in _FAST_METHODS):
        raise ValueError(f"the frozen reference holds the fast path only, not {cfg.method} "
                         f"(use_fast_path={cfg.use_fast_path}, regularization={cfg.regularization})")


def prepare(xyz, mask, cfg: RegistrationConfig, device="cuda") -> PreparedCloud:
    """Covariance estimation on the fast path (cfg.covariance_method KNN or
    RBF). xyz [B, N, 3] or [N, 3]."""
    from benchmark.reference.plain.frontend import apdgicp_fast

    _fast_path(cfg)
    dev = resolve(device)
    xyz = _as_tensor(xyz, dev)
    mask = _as_tensor(mask, dev)
    if xyz.ndim == 2:
        return _map(prepare(xyz[None], mask[None], cfg, dev), lambda t: t[0])
    if cfg.covariance_method == "RBF":
        return apdgicp_fast.estimate_covariances_rbf_fast(xyz, mask, cfg)
    return apdgicp_fast.estimate_covariances_fast(xyz, mask, cfg)


def register_dispatch(source: PreparedCloud, target: PreparedCloud, guess, cfg: RegistrationConfig,
                      device="cuda") -> RegistrationResult:
    """The fast path's registration (registrations.cpp:38-140), eager."""
    from benchmark.reference.plain.frontend import apdgicp_fast

    _fast_path(cfg)
    dev = resolve(device)
    source = _map(source, lambda t: t.to(dev))
    target = _map(target, lambda t: t.to(dev))
    guess = _as_tensor(guess, dev)
    if source.xyz.ndim == 2:
        batched = register_dispatch(_map(source, lambda t: t[None]), _map(target, lambda t: t[None]),
                                    guess[None], cfg, dev)
        return _map(batched, lambda t: t[0])
    return apdgicp_fast.register_fast(source, target, guess, cfg)
