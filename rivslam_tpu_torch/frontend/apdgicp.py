"""APDGICP scan registration: dispatch and result types (port of
``rivslam_tpu/frontend/apdgicp.py``).

The port batches over a leading problem dim B where the reference vmaps.
``prepare``, ``register_dispatch`` and ``prepare_and_register`` also take a
single unbatched problem, as the reference's do, and then return unbatched
results.

Ported so far: the fast (structure-of-arrays) path for PLANE covariances and
the FAST_APDGICP / FAST_GICP / GICP / GICP_OMP registration. The exact
``register`` and ``estimate_covariances``, ICP, VGICP and NDT raise
NotImplementedError until their slice of the port (ROADMAP.md, open items,
queue 1 "Modules still to port").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.core.device import resolve

_QUEUE = "not ported yet: see ROADMAP.md, open items, queue 1 (modules still to port)"


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


def prepare(xyz, mask, cfg: RegistrationConfig, device="cuda") -> PreparedCloud:
    """Covariance estimation honoring cfg.use_fast_path and
    cfg.covariance_method (KNN | RBF). xyz [B, N, 3] or [N, 3]."""
    dev = resolve(device)
    xyz = _as_tensor(xyz, dev)
    mask = _as_tensor(mask, dev)
    if xyz.ndim == 2:
        return _map(prepare(xyz[None], mask[None], cfg, dev), lambda t: t[0])
    if not (cfg.use_fast_path and cfg.regularization == "PLANE"):
        raise NotImplementedError(
            f"exact covariance estimation (use_fast_path={cfg.use_fast_path}, "
            f"regularization={cfg.regularization!r}) is {_QUEUE}"
        )
    from rivslam_tpu_torch.frontend import apdgicp_fast

    if cfg.covariance_method == "RBF":
        return apdgicp_fast.estimate_covariances_rbf_fast(xyz, mask, cfg)
    return apdgicp_fast.estimate_covariances_fast(xyz, mask, cfg)


def register_dispatch(
    source: PreparedCloud, target: PreparedCloud, guess, cfg: RegistrationConfig,
    device="cuda",
) -> RegistrationResult:
    """Method factory (registrations.cpp:38-140): FAST_APDGICP / FAST_GICP /
    GICP / GICP_OMP take the structure-of-arrays fast path."""
    dev = resolve(device)
    source = _map(source, lambda t: t.to(dev))
    target = _map(target, lambda t: t.to(dev))
    guess = _as_tensor(guess, dev)
    if source.xyz.ndim == 2:
        batched = register_dispatch(
            _map(source, lambda t: t[None]), _map(target, lambda t: t[None]),
            guess[None], cfg, dev,
        )
        return _map(batched, lambda t: t[0])
    m = cfg.method
    if cfg.use_fast_path and m in ("FAST_APDGICP", "FAST_GICP", "GICP", "GICP_OMP"):
        from rivslam_tpu_torch.frontend import apdgicp_fast

        return apdgicp_fast.register_fast(source, target, guess, cfg)
    raise NotImplementedError(
        f"registration method {m!r} (use_fast_path={cfg.use_fast_path}) is {_QUEUE}"
    )


def prepare_and_register(
    src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: RegistrationConfig,
    device="cuda",
) -> RegistrationResult:
    """Convenience: covariance estimation + registration in one call."""
    source = prepare(src_xyz, src_mask, cfg, device)
    target = prepare(tgt_xyz, tgt_mask, cfg, device)
    return register_dispatch(source, target, guess, cfg, device)
