"""One rank of the gloo world that tests/test_torch_dist.py starts: every
distributed check of the port's dist layer in one world, on the CPU.

    python tests/torch_dist_world.py INPUTS.pkl OUT.pkl RANK WORLD INIT_FILE

INPUTS.pkl holds numpy arrays made by the test (the registration scene, the
pose graphs, the odometry sequence, the sliding windows, the fleet's
sequences); rank 0 writes
what each check returned to OUT.pkl. The port only: no JAX here. The rank
takes the test process's torch thread count, so that its reductions run in
the same order.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np
import torch

import torch_shared_cache  # noqa: F401  (the thread count)

from rivslam_tpu_torch import pipeline
from rivslam_tpu_torch.core.config import BackendConfig, EngineConfig, OdometryConfig, RegistrationConfig
from rivslam_tpu_torch.dist import dist_gn, dist_graph, mesh as mesh_mod
from rivslam_tpu_torch.factors.preintegration import Preintegration
from rivslam_tpu_torch.frontend import apdgicp
from rivslam_tpu_torch.loop import block_schur, global_graph
from rivslam_tpu_torch.solver import window as win

CFG = RegistrationConfig(transformation_epsilon=5e-4)
FAST_CFG = RegistrationConfig(method="FAST_GICP", transformation_epsilon=5e-4)


def _raises(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def run(inp: dict, rank: int, world: int, init_file: str) -> dict:
    mesh_mod.init_world("gloo", rank, world, init_file, timeout_s=120.0)
    out: dict = {}
    try:
        m22 = mesh_mod.make_mesh(2, 2)
        out["mesh_shape"] = tuple(m22.shape)
        out["mesh_names"] = tuple(m22.mesh_dim_names)
        out["refused"] = _raises(lambda: mesh_mod.make_mesh(world, 2))
        out["slice_refused"] = _raises(lambda: mesh_mod.local_slice(torch.zeros(world + 1), m22, "data"))

        def cloud(key):
            return apdgicp.PreparedCloud(**{f: torch.as_tensor(inp[key][f]) for f in ("xyz", "mask", "cov")})

        src, tgt = cloud("src"), cloud("tgt")
        eye = torch.eye(4, dtype=torch.float64)
        B = 8

        def stack(c):
            return apdgicp.PreparedCloud(xyz=c.xyz.expand(B, -1, -1), mask=c.mask.expand(B, -1),
                                         cov=c.cov.expand(B, -1, -1, -1))

        res = dist_gn.batched_register(stack(src), stack(tgt), eye.expand(B, 4, 4), CFG,
                                       mesh_mod.make_mesh(world, 1))
        out["batched_T"] = res.T.numpy()
        m_model = mesh_mod.make_mesh(1, world)
        res = dist_gn.sharded_register(src, tgt, eye, CFG, m_model)
        out["sharded_T"], out["sharded_ncorr"] = res.T.numpy(), int(res.num_correspondences)
        out["sharded_error"] = float(res.error)

        def graph(key):
            return global_graph.PoseGraph(**{k: torch.as_tensor(v) for k, v in inp[key].items()})

        gd, chi2 = dist_graph.solve_pose_graph_sharded(graph("graph_plain"), m_model, gn_iters=6)
        out["pcg_p"], out["pcg_chi2"] = gd.p.numpy(), float(chi2)
        g = graph("graph")
        gd, chi2 = block_schur.solve_pose_graph_schur_sharded(g, m_model, num_blocks=8, gn_iters=6)
        out["schur_p"], out["schur_chi2"] = gd.p.numpy(), float(chi2)
        out["schur_refused"] = [_raises(lambda: block_schur.solve_pose_graph_schur_sharded(
            g, m_model, num_blocks=nb, gn_iters=1)) for nb in (6, 2)]

        S = world
        r = inp["replay"]
        poses, kf, conv = dist_gn.batched_replay_odometry(
            *(np.stack([r[k]] * S) for k in ("xyz", "mask", "ego", "times")),
            OdometryConfig(use_ego_vel=True), FAST_CFG, mesh_mod.make_mesh(world, 1), device="cpu")
        out["replay_poses"], out["replay_kf"], out["replay_conv"] = poses.numpy(), kf.numpy(), conv.numpy()

        def tree(cls, d):
            return cls(**{k: tree(Preintegration, v) if isinstance(v, dict) else torch.as_tensor(v)
                          for k, v in d.items()})

        x, chi2, iters = dist_gn.batched_window_solve(
            tree(win.WindowState, inp["windows"][0]), tree(win.WindowFactors, inp["windows"][1]),
            BackendConfig(max_solver_iterations=12), inp["bias_info"], mesh_mod.make_mesh(world, 1))
        out["window_x"] = {k: v.numpy() for k, v in zip(("R", "p", "v", "bg", "ba"), x.astuple())}
        out["window_chi2"], out["window_iters"] = chi2.numpy(), iters.numpy()

        batch = inp["fleet"]
        eng = pipeline.Engine(EngineConfig(), seed=3, device="cpu")
        out["fleet_meshed"] = eng.replay_fleet(batch, mesh=m22, axis="data")
        if rank == 0:
            out["fleet_plain"] = pipeline.Engine(EngineConfig(), seed=3, device="cpu").replay_fleet(batch)
        return out
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    inputs, out_path, rank, world, init_file = sys.argv[1:]
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    result = run(inp, int(rank), int(world), init_file)
    if int(rank) == 0:
        with open(out_path, "wb") as f:
            pickle.dump(result, f)
