"""Faults planted in the program under test for the cp.vgicp and cp.replay
cells, beside ``benchmark/faults.py``'s (a registration that returns its
guess or stops after one LM iteration serve both cells too). Importing this
module adds them to ``faults.FAULTS``, so ``faults.planted(name)`` plants
them; run as a script it is ``benchmark/readings.py`` with them added:

    python3 benchmark/faults_voxel_replay.py --workload cp.vgicp --seconds 8 \\
        --seeds 11 --no-control --fault voxel_point_spread voxel_unweighted

``benchmark/tests/test_bench_voxel_replay.py`` shows each failing the
check on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import faults  # noqa: E402


def _voxel_point_spread(vgicp):
    """VGICP's voxel map built as NDT's, whatever covariances it is given:
    each voxel's point spread with its eigenvalues clamped at 1e-3. Built on
    the host: cuSOLVER's batched ``eigh`` refuses B x V matrices at the
    cell's size (CUSOLVER_STATUS_INVALID_VALUE on an H100)."""
    inner = vgicp.build_voxel_map

    def build_voxel_map(xyz, mask, cfg, capacity=2048, cov=None):
        vm = inner(xyz.cpu(), mask.cpu(), cfg, capacity)
        return type(vm)(**{f: getattr(vm, f).to(xyz.device) for f in ("coords", "mean", "cov", "count")})

    return build_voxel_map


def _voxel_unweighted(vgicp):
    """VGICP's correspondences weighted 1 in place of sqrt(N_v): NDT's
    models stand in for VGICP's."""
    return dict(vgicp.NDT_MODELS)


def _draws_shifted(pipeline):
    """The Engine with every frame's RANSAC draws taken from the frame
    before it (the first frame's from the last)."""
    inner = pipeline.Engine

    class Engine(inner):
        def _draw_sequence(self, *args, **kwargs):
            return tuple(torch.roll(u, 1, dims=0) for u in super()._draw_sequence(*args, **kwargs))

    return Engine


def _backend_left_out(slam):
    """A window backend that leaves out every seventh frame after the
    first: it returns its state unchanged and the previous frame's pose."""
    inner = slam.backend_step
    seen = {"n": 0, "pose": None}

    def backend_step(state, frame, *args, **kwargs):
        seen["n"] += 1
        if seen["n"] % 7 == 0 and seen["pose"] is not None:
            _, out = inner(state, frame, *args, **kwargs)
            return state, dataclasses.replace(out, pose=seen["pose"])
        new, out = inner(state, frame, *args, **kwargs)
        seen["pose"] = out.pose
        return new, out

    return backend_step


# name: (the program's module, the attribute replaced, the fault's maker)
FAULTS = {
    "voxel_point_spread": ("frontend.vgicp", "build_voxel_map", _voxel_point_spread),
    "voxel_unweighted": ("frontend.vgicp", "MODELS", _voxel_unweighted),
    "draws_shifted": ("pipeline", "Engine", _draws_shifted),
    "backend_left_out": ("backend.slam", "backend_step", _backend_left_out),
}
faults.FAULTS.update(FAULTS)


if __name__ == "__main__":
    from benchmark import readings

    sys.exit(readings.main())
