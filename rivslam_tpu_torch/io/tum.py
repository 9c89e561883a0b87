"""TUM-format trajectory export/import (port of ``rivslam_tpu/io/tum.py``).

Format parity with the reference's `/command "output_aftmapped"` export
(radar_graph_slam_nodelet.cpp:1272-1293): one line per pose,
`timestamp tx ty tz qx qy qz qw`, consumable by rpg_trajectory_evaluation.
The quaternions come from the port's ``lie.rot_to_quat`` in float64 on the
CPU, so a trajectory writes the same bytes as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from rivslam_tpu_torch.core import lie


def save_tum(path: str, times: np.ndarray, poses: np.ndarray) -> None:
    """times [F], poses [F,4,4] -> TUM text file."""
    poses = np.asarray(poses, np.float64)
    q = lie.rot_to_quat(torch.as_tensor(poses[:, :3, :3])).numpy()  # [F,4] wxyz
    t = poses[:, :3, 3]
    with open(path, "w") as f:
        for i in range(len(times)):
            f.write(
                f"{times[i]:.9f} {t[i,0]:.9f} {t[i,1]:.9f} {t[i,2]:.9f} "
                f"{q[i,1]:.9f} {q[i,2]:.9f} {q[i,3]:.9f} {q[i,0]:.9f}\n"
            )


def load_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """TUM text file -> (times [F], poses [F,4,4])."""
    data = np.loadtxt(path).reshape(-1, 8)
    times = data[:, 0]
    q_wxyz = np.concatenate([data[:, 7:8], data[:, 4:7]], axis=1)
    poses = np.tile(np.eye(4), (len(times), 1, 1))
    poses[:, :3, :3] = lie.quat_to_rot(torch.as_tensor(q_wxyz)).numpy()
    poses[:, :3, 3] = data[:, 1:4]
    return times, poses


def associate_by_stamp(stamps_a: np.ndarray, stamps_b: np.ndarray,
                       max_dt: float = 0.05) -> list[tuple[int, int]]:
    """Nearest-stamp association (gps_traj_align.cpp ``associate``; a copy of
    ``rivslam_tpu/tools.associate_by_stamp``): both stamp lists ascending."""
    pairs = []
    j = 0
    for i, t in enumerate(stamps_a):
        while j + 1 < len(stamps_b) and abs(stamps_b[j + 1] - t) <= abs(stamps_b[j] - t):
            j += 1
        if abs(stamps_b[j] - t) <= max_dt:
            pairs.append((i, j))
    return pairs
