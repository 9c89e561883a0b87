"""Distributed registration and batched solves over a process mesh (port of
``rivslam_tpu/dist/dist_gn.py``).

- ``batched_register``: the data axis. B independent frame pairs; each rank
  registers its contiguous slice of B (the exact ``apdgicp.register``, one
  K2 launch per correspondence step) with no communication until the
  results are gathered.
- ``sharded_register``: the model axis. One registration with its source
  points split over the ranks of ``axis``; correspondences are computed
  locally against the whole target and H, b and the error partials are
  summed with ``all_reduce`` at each linearization and try (the
  reference's psum, the OpenMP ``reduction(+:...)`` of
  fast_apdgicp_impl.hpp:221-260 as a collective). It runs eagerly.
- ``batched_window_solve`` and ``batched_replay_odometry``: the data axis
  over sliding windows and over whole sequences.

Every function is SPMD: each rank is given the full inputs and returns
the full result, equal on every rank (``dist/mesh.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from rivslam_tpu_torch.core.config import BackendConfig, RegistrationConfig
from rivslam_tpu_torch.dist.mesh import gather, local_slice
from rivslam_tpu_torch.frontend import apdgicp, replay_device
from rivslam_tpu_torch.solver import window as win


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _gather_result(res: apdgicp.RegistrationResult, mesh, axis: str) -> apdgicp.RegistrationResult:
    return apdgicp.RegistrationResult(**{k: gather(v, mesh, axis) for k, v in _fields(res).items()})


def batched_register(
    sources: apdgicp.PreparedCloud,
    targets: apdgicp.PreparedCloud,
    guesses: torch.Tensor,
    cfg: RegistrationConfig,
    mesh,
    axis: str = "data",
) -> apdgicp.RegistrationResult:
    """Register B independent frame pairs (fields [B, N, ...], guesses
    [B, 4, 4]), B split over ``axis``: this rank's slice through the exact
    ``register``, the results gathered. B must divide by the axis size."""
    def cut(cloud):
        return apdgicp.PreparedCloud(**{k: local_slice(v, mesh, axis) for k, v in _fields(cloud).items()})

    res = apdgicp.register(cut(sources), cut(targets), local_slice(guesses, mesh, axis), cfg)
    return _gather_result(res, mesh, axis)


def sharded_register(
    source: apdgicp.PreparedCloud,
    target: apdgicp.PreparedCloud,
    guess: torch.Tensor,
    cfg: RegistrationConfig,
    mesh,
    axis: str = "model",
) -> apdgicp.RegistrationResult:
    """One exact registration (fields [N, ...] or [1, N, ...], guess
    [4, 4] or [1, 4, 4]) with the source points split over ``axis``; H, b
    and the error partials are summed over the axis. N must divide by the
    axis size. Every rank returns the same result, unbatched as given."""
    batched = source.xyz.ndim == 3
    if not batched:
        source, target = (apdgicp._map(c, lambda t: t[None]) for c in (source, target))
        guess = guess[None]

    def cut(t):
        return local_slice(t.transpose(0, 1), mesh, axis).transpose(0, 1)

    part = apdgicp.PreparedCloud(xyz=cut(source.xyz), mask=cut(source.mask), cov=cut(source.cov))
    res = apdgicp.register(part, target, guess, cfg, group=mesh.get_group(axis))
    return res if batched else apdgicp._map(res, lambda t: t[0])


def batched_window_solve(
    states: win.WindowState,
    factors: win.WindowFactors,
    cfg: BackendConfig,
    bias_info: tuple[float, float],
    mesh,
    axis: str = "data",
) -> tuple[win.WindowState, torch.Tensor, torch.Tensor]:
    """Solve B independent sliding windows (every field with a leading [B]),
    B split over ``axis``. The port's ``solve_window`` solves one window, so
    each rank solves its windows one after another: on the card through one
    ``GraphedSolver``, captured for the first and replayed for every other
    window of the slice; on the CPU eagerly. Returns (states, chi2 [B],
    iterations [B]), gathered."""
    def cut(obj):
        return type(obj)(**{k: cut(v) if dataclasses.is_dataclass(v) else local_slice(v, mesh, axis)
                            for k, v in _fields(obj).items()})

    def pick(obj, i):
        return type(obj)(**{k: pick(v, i) if dataclasses.is_dataclass(v) else v[i]
                            for k, v in _fields(obj).items()})

    x_loc, f_loc = cut(states), cut(factors)
    n, dev = x_loc.p.shape[0], x_loc.p.device
    solve = (win.GraphedSolver(cfg, tuple(bias_info), x_loc.p.shape[1], x_loc.p.dtype, dev)
             if dev.type == "cuda" else
             lambda x, f: win.solve_window(x, f, cfg, tuple(bias_info)))
    outs = [solve(pick(x_loc, i), pick(f_loc, i)) for i in range(n)]
    x = win.WindowState(*(torch.stack(ts) for ts in zip(*(o[0].astuple() for o in outs))))
    chi2 = torch.stack([o[1] for o in outs])
    iters = torch.tensor([o[2] for o in outs], dtype=torch.int32, device=dev)
    return (win.WindowState(*(gather(t, mesh, axis) for t in x.astuple())),
            gather(chi2, mesh, axis), gather(iters, mesh, axis))


def batched_replay_odometry(
    xyz,  # [S, F, N, 3] S independent sequences
    mask,  # [S, F, N]
    ego_vel,  # [S, F, 3]
    times,  # [S, F]
    odo_cfg,
    reg_cfg: RegistrationConfig,
    mesh,
    axis: str = "data",
    device="cuda",
):
    """S independent sequences split over ``axis``, each replayed through
    ``replay_device.replay_odometry`` on its rank (the production serving
    form: throughput grows with ranks while a sequence's latency stays).
    Returns (poses [S,F,4,4], is_keyframe [S,F], converged [S,F]),
    gathered."""
    dev = torch.device(device)
    parts = [local_slice(torch.as_tensor(a).to(dev), mesh, axis) for a in (xyz, mask, ego_vel, times)]
    outs = [replay_device.replay_odometry(*(p[s] for p in parts), odo_cfg, reg_cfg, device=dev)
            for s in range(parts[0].shape[0])]
    return tuple(gather(torch.stack(ts), mesh, axis) for ts in zip(*outs))
