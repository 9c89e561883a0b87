"""Offline trajectory tools (port of ``rivslam_tpu/tools.py``): the
reference's gt_adjust and gps_traj_align.

- ``adjust_trajectory``: a chain pose graph of a trajectory plus manual loop
  edges, optimized (src/gt_adjust.cpp:54-99);
- ``align_gps_trajectory``: trajectory and GPS associated by stamp, and the
  UTM -> world transform estimated (src/gps_traj_align.cpp:226-250, which
  optimizes one SE3 node over EdgeSE3GtUTM edges: the closed-form
  least-squares alignment here).

They run on the CPU unless ``device`` says otherwise: a pose graph of a few
hundred nodes is host-sized work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rivslam_tpu_torch.eval.ate import umeyama_alignment
from rivslam_tpu_torch.io.tum import associate_by_stamp
from rivslam_tpu_torch.loop import global_graph

__all__ = ["adjust_trajectory", "associate_by_stamp", "align_gps_trajectory"]


def adjust_trajectory(
    poses: np.ndarray,  # [F,4,4]
    loop_edges: list[tuple[int, int, np.ndarray]],  # (i, j, T_i^-1 T_j measurement)
    odom_info: float = 100.0,
    loop_info: float = 400.0,
    dtype=torch.float64,
    device="cpu",
) -> np.ndarray:
    """The chain graph plus manual loop edges -> the optimized trajectory."""
    n = len(poses)
    K = 1 << max(3, (n - 1).bit_length())
    L = max(8, len(loop_edges))
    g = global_graph.PoseGraph.create(K, L, dtype=dtype, device=device)
    rels = np.stack([np.eye(4)] + [np.linalg.inv(poses[i - 1]) @ poses[i] for i in range(1, n)])

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def rows(field, k, value):
        out = getattr(g, field).clone()
        out[k] = value
        return out

    g = dataclasses.replace(
        g,
        R=rows("R", slice(0, n), t(poses[:, :3, :3])),
        p=rows("p", slice(0, n), t(poses[:, :3, 3])),
        node_mask=rows("node_mask", slice(0, n), True),
        odom_rel_R=rows("odom_rel_R", slice(0, n), t(rels[:, :3, :3])),
        odom_rel_p=rows("odom_rel_p", slice(0, n), t(rels[:, :3, 3])),
        odom_info=rows("odom_info", slice(0, n), t(np.eye(6) * odom_info)),
    )
    for k, (i, j, T) in enumerate(loop_edges):
        g = dataclasses.replace(
            g,
            loop_i=rows("loop_i", k, i), loop_j=rows("loop_j", k, j),
            loop_rel_R=rows("loop_rel_R", k, t(T[:3, :3])), loop_rel_p=rows("loop_rel_p", k, t(T[:3, 3])),
            loop_info=rows("loop_info", k, t(np.eye(6) * loop_info)), loop_mask=rows("loop_mask", k, True),
        )
    g_opt, _ = global_graph.solve_pose_graph(g)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = g_opt.R[:n].cpu().numpy()
    out[:, :3, 3] = g_opt.p[:n].cpu().numpy()
    return out


def align_gps_trajectory(
    traj_stamps: np.ndarray,
    traj_pos: np.ndarray,  # [F,3] world positions
    gps_stamps: np.ndarray,
    gps_utm: np.ndarray,  # [G,3] UTM positions
    max_dt: float = 0.05,
) -> tuple[np.ndarray, np.ndarray, list[tuple[int, int]]]:
    """world_T_utm = (R, t) minimizing ||world - (R utm + t)||, and the
    associated (trajectory, GPS) index pairs."""
    pairs = associate_by_stamp(traj_stamps, gps_stamps, max_dt)
    if len(pairs) < 3:
        raise ValueError(f"only {len(pairs)} stamp associations")
    a = np.stack([gps_utm[j] for _, j in pairs])
    b = np.stack([traj_pos[i] for i, _ in pairs])
    _, R, t = umeyama_alignment(a, b, with_scale=False)
    return R, t, pairs
