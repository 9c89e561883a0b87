"""Faults planted in the program under test, to show that the correctness
check sees them: each breaks the timed path where the program produces the
answer, and ``planted(name)`` puts the program back when it ends.

    with faults.planted("registration_returns_guess"):
        run.run_cell(...)

The benchmark's own runs plant nothing. ``benchmark/readings.py --fault``
reads a fault's numbers on the card at a cell's own size, and
``benchmark/tests/test_bench_faults.py`` shows each fault failing the
check on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch


def _registration_returns_guess(apdgicp):
    """A registration that returns its guess, with the error at the guess,
    as converged: no LM iteration runs."""
    inner = apdgicp.register_dispatch

    def register_dispatch(source, target, guess, cfg, *args, **kwargs):
        res = inner(source, target, guess, dataclasses.replace(cfg, max_iterations=0), *args, **kwargs)
        return dataclasses.replace(res, converged=torch.ones_like(res.converged))

    return register_dispatch


def _registration_one_iteration(apdgicp):
    """A registration that stops after its first LM iteration."""
    inner = apdgicp.register_dispatch

    def register_dispatch(source, target, guess, cfg, *args, **kwargs):
        return inner(source, target, guess, dataclasses.replace(cfg, max_iterations=1), *args, **kwargs)

    return register_dispatch


def _registration_moved(apdgicp):
    """Every registration's answer moved 1 cm along x where it is produced."""
    inner = apdgicp.register_dispatch

    def register_dispatch(*args, **kwargs):
        res = inner(*args, **kwargs)
        T = res.T.clone()
        T[..., 0, 3] += 0.01
        return dataclasses.replace(res, T=T)

    return register_dispatch


def _registration_half_batch(apdgicp):
    """Half of a batch of registrations left out, the mean over the rest
    standing in for every field of the left-out half."""
    inner = apdgicp.register_dispatch

    def register_dispatch(source, target, guess, cfg, *args, **kwargs):
        if guess.ndim != 3 or guess.shape[0] < 2:
            return inner(source, target, guess, cfg, *args, **kwargs)
        h = guess.shape[0] // 2

        def cut(c):
            return type(c)(**{f.name: getattr(c, f.name)[:h] for f in dataclasses.fields(c)})

        res = inner(cut(source), cut(target), guess[:h], cfg, *args, **kwargs)

        def fill(t):
            mean = t.float().mean(0, keepdim=True).to(t.dtype)
            return torch.cat([t, mean.expand(guess.shape[0] - h, *t.shape[1:])])

        return type(res)(**{f.name: fill(getattr(res, f.name)) for f in dataclasses.fields(res)})

    return register_dispatch


def _solve_unchanged(block_schur):
    """A global solve that returns the graph it received, with its chi2."""
    global_graph = importlib.import_module("rivslam_tpu_torch.loop.global_graph")

    def solve(g, *args, huber_delta: float = 1.0, **kwargs):
        return g, global_graph.linearize(g, huber_delta)[-1]

    return solve


def _solve_one_iteration(block_schur):
    """A global solve that stops after its first trust-region iteration."""
    inner = block_schur.solve_pose_graph_schur

    def solve(g, *args, **kwargs):
        return inner(g, *args, **{**kwargs, "gn_iters": 1})

    return solve


def _backend_unchanged(slam):
    """A window backend that, after its first frame, returns its state
    unchanged and the previous frame's pose."""
    inner = slam.backend_step
    last: dict = {}

    def backend_step(state, frame, *args, **kwargs):
        new, out = inner(state, frame, *args, **kwargs)
        if "pose" not in last:
            last["pose"] = out.pose
            return new, out
        return state, dataclasses.replace(out, pose=last["pose"])

    return backend_step


def _ego_velocity_altered(reve):
    """REVE's ego velocity 1 mm/s off along every axis."""
    inner = reve.estimate_ego_velocity

    def estimate_ego_velocity(*args, **kwargs):
        res = inner(*args, **kwargs)
        return dataclasses.replace(res, v=res.v + 1e-3)

    return estimate_ego_velocity


# name: (the program's module, the function replaced, the fault's maker)
FAULTS = {
    "registration_returns_guess": ("frontend.apdgicp", "register_dispatch", _registration_returns_guess),
    "registration_one_iteration": ("frontend.apdgicp", "register_dispatch", _registration_one_iteration),
    "registration_moved": ("frontend.apdgicp", "register_dispatch", _registration_moved),
    "registration_half_batch": ("frontend.apdgicp", "register_dispatch", _registration_half_batch),
    "solve_unchanged": ("loop.block_schur", "solve_pose_graph_schur", _solve_unchanged),
    "solve_one_iteration": ("loop.block_schur", "solve_pose_graph_schur", _solve_one_iteration),
    "backend_unchanged": ("backend.slam", "backend_step", _backend_unchanged),
    "ego_velocity_altered": ("frontend.reve", "estimate_ego_velocity", _ego_velocity_altered),
}


@contextlib.contextmanager
def planted(name: str | None):
    """The fault ``name`` in the program inside the block (none for None)."""
    if name is None:
        yield
        return
    module_name, attr, make = FAULTS[name]
    module = importlib.import_module(f"rivslam_tpu_torch.{module_name}")
    original = getattr(module, attr)
    setattr(module, attr, make(module))
    try:
        yield
    finally:
        setattr(module, attr, original)
