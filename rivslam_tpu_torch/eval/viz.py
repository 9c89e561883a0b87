"""Visualization export — the RViz-marker parity layer, without ROS (port
of ``rivslam_tpu/eval/viz.py``).

The reference publishes node/edge/loop-edge/velocity markers + paths + the
aggregated map for RViz (radar_graph_slam_nodelet.cpp:811-1070). Here the
same artifacts export to universal formats any viewer opens
(CloudCompare/Meshlab/Open3D): PLY point clouds with per-vertex color, and
a JSON graph summary (nodes, odometry edges, loop edges) for plotting.
"""

from __future__ import annotations

import json

import numpy as np


def save_ply(path: str, xyz: np.ndarray, colors: np.ndarray | None = None) -> None:
    """ASCII PLY; colors [N,3] uint8 optional."""
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{xyz[i,0]:.5f} {xyz[i,1]:.5f} {xyz[i,2]:.5f}"
            if colors is not None:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            f.write(row + "\n")


def export_session(engine, prefix: str) -> dict:
    """Write <prefix>_traj.ply (trajectory, green), <prefix>_keyframes.ply
    (optimized keyframe positions, red), <prefix>_map.ply (map points, gray)
    and <prefix>_graph.json (nodes + edges + loops). Returns written paths."""
    import torch

    from rivslam_tpu_torch.backend import map as map_mod

    written = {}
    ts, poses = engine.trajectory()
    if len(ts):
        p = poses[:, :3, 3]
        c = np.tile(np.array([[40, 200, 80]], dtype=np.uint8), (len(p), 1))
        save_ply(f"{prefix}_traj.ply", p, c)
        written["trajectory"] = f"{prefix}_traj.ply"

    st = engine.state
    if st.graph is not None and st.kf_count:
        kf = engine.optimized_keyframe_poses()
        p = kf[:, :3, 3]
        c = np.tile(np.array([[220, 60, 60]], dtype=np.uint8), (len(p), 1))
        save_ply(f"{prefix}_keyframes.ply", p, c)
        written["keyframes"] = f"{prefix}_keyframes.ply"

        loops = []
        lm = st.graph.loop_mask.cpu().numpy()
        li = st.graph.loop_i.cpu().numpy()
        lj = st.graph.loop_j.cpu().numpy()
        for k in range(len(lm)):
            if lm[k]:
                loops.append({"i": int(li[k]), "j": int(lj[k])})
        graph = {
            "num_keyframes": st.kf_count,
            "nodes": p.tolist(),
            "odometry_edges": [[i - 1, i] for i in range(1, st.kf_count)],
            "loop_edges": loops,
        }
        with open(f"{prefix}_graph.json", "w") as f:
            json.dump(graph, f)
        written["graph"] = f"{prefix}_graph.json"

    if st.kf_clouds:
        kf_xyz = torch.stack([x for x, _ in st.kf_clouds])
        kf_mask = torch.stack([m for _, m in st.kf_clouds])
        kf_poses = torch.as_tensor(engine.optimized_keyframe_poses(), device=kf_xyz.device)
        map_xyz, valid = map_mod.assemble_map(kf_xyz, kf_mask, kf_poses, resolution=0.2)
        pts = map_xyz[valid].cpu().numpy()
        save_ply(f"{prefix}_map.ply", pts)
        written["map"] = f"{prefix}_map.ply"

    # scan-context descriptor sheet (loop_detector.cpp:302-312 publishes the
    # SC matrix as an image topic; here: one PGM of all keyframe descriptors
    # stacked vertically, rows = keyframes x rings, cols = sectors)
    if st.scdb is not None:
        n = int(st.scdb.count)
        if n > 0:
            sheet = st.scdb.desc[:n].cpu().numpy()  # [n, R, S]
            hi = float(sheet.max())
            img = (sheet / hi * 255.0 if hi > 0 else sheet).astype(np.uint8)
            img = img.reshape(n * sheet.shape[1], sheet.shape[2])
            save_pgm(f"{prefix}_scancontext.pgm", img)
            written["scancontext"] = f"{prefix}_scancontext.pgm"
    return written


def save_pgm(path: str, img: np.ndarray) -> None:
    """Binary PGM (P5) grayscale image writer."""
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, dtype=np.uint8).tobytes())
