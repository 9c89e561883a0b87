"""g2o text-format pose-graph export/import + robust-kernel sidecar (port of
``rivslam_tpu/io/g2o_io.py``; the text is written from numpy, so a graph
writes the same bytes as the reference's).

The reference's DumpGraph service writes the optimizer as a standard g2o
text file plus a robust-kernel sidecar (`graph_slam.cpp:512-538` g2o
save/load; `src/g2o/robust_kernel_io.cpp` writes one `kernel delta` line
per edge). This module gives the same interop: a session's global pose
graph (loop/global_graph.PoseGraph) round-trips through the standard
`VERTEX_SE3:QUAT` / `EDGE_SE3:QUAT` vocabulary, so external g2o tooling
(g2o_viewer, g2o CLI optimizers) can load what we dump and vice versa.

Conventions:
- g2o orders the 6-dof tangent translation-first; this codebase orders it
  rotation-first ([theta, p] — see global_graph.retract). Information
  matrices are block-permuted on the way out/in.
- The odometry chain is emitted as consecutive (i-1, i) EDGE_SE3:QUAT
  lines; anything non-consecutive is a loop edge. Import rebuilds exactly
  that structure (the PoseGraph stores the chain and loops separately).
- `FIX 0` anchors the first node (the reference's anchor node role,
  radar_graph_slam_nodelet.cpp:689-691).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rivslam_tpu_torch.loop.global_graph import PoseGraph

# block permutation between [theta, p] (ours) and [p, theta] (g2o)
_PERM = np.array([3, 4, 5, 0, 1, 2])


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """[qx, qy, qz, qw] from a rotation matrix (numpy, Shepperd's method)."""
    m = R
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        qw = (m[2, 1] - m[1, 2]) / s
        qx = 0.25 * s
        qy = (m[0, 1] + m[1, 0]) / s
        qz = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        qw = (m[0, 2] - m[2, 0]) / s
        qx = (m[0, 1] + m[1, 0]) / s
        qy = 0.25 * s
        qz = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        qw = (m[1, 0] - m[0, 1]) / s
        qx = (m[0, 2] + m[2, 0]) / s
        qy = (m[1, 2] + m[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qx, qy, qz, qw])
    return q / np.linalg.norm(q)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _info_out(info6: np.ndarray) -> np.ndarray:
    """[theta,p]-ordered 6x6 -> g2o [p,theta] upper-triangular 21-vector."""
    g = info6[np.ix_(_PERM, _PERM)]
    return g[np.triu_indices(6)]


def _info_in(vals: np.ndarray) -> np.ndarray:
    """g2o upper-triangular 21-vector -> [theta,p]-ordered 6x6."""
    g = np.zeros((6, 6))
    g[np.triu_indices(6)] = vals
    g = g + np.triu(g, 1).T
    return g[np.ix_(_PERM, _PERM)]


def _edge_line(i: int, j: int, R: np.ndarray, p: np.ndarray, info: np.ndarray) -> str:
    q = _rot_to_quat(R)
    meas = " ".join(f"{v:.9g}" for v in (*p, *q))
    inf = " ".join(f"{v:.9g}" for v in _info_out(info))
    return f"EDGE_SE3:QUAT {i} {j} {meas} {inf}"


def export_g2o(
    graph: PoseGraph,
    path: str,
    loop_kernel: tuple[str, float] = ("Huber", 1.0),
) -> int:
    """Write the active nodes + odometry chain + loop edges as g2o text.
    Also writes the reference-style robust-kernel sidecar
    (`<path>.kernels`: one `edge_index kernel delta` line per loop edge —
    robust_kernel_io.cpp writes kernels keyed by edge order; odometry
    edges carry none, launch:160-162). Returns the number of nodes."""
    def a(t, dtype=None):
        return np.asarray(t.cpu().numpy(), dtype)

    node_mask = a(graph.node_mask)
    n = int(node_mask.sum())
    R, p = a(graph.R, np.float64), a(graph.p, np.float64)
    rel_R, rel_p = a(graph.odom_rel_R, np.float64), a(graph.odom_rel_p, np.float64)
    odom_info = a(graph.odom_info, np.float64)
    lmask, li, lj = a(graph.loop_mask), a(graph.loop_i), a(graph.loop_j)
    lR, lp = a(graph.loop_rel_R, np.float64), a(graph.loop_rel_p, np.float64)
    linfo = a(graph.loop_info, np.float64)

    lines = []
    for i in range(n):
        q = _rot_to_quat(R[i])
        vals = " ".join(f"{v:.9g}" for v in (*p[i], *q))
        lines.append(f"VERTEX_SE3:QUAT {i} {vals}")
    lines.append("FIX 0")
    for i in range(1, n):
        lines.append(_edge_line(i - 1, i, rel_R[i], rel_p[i], odom_info[i]))
    n_loops = 0
    kernel_lines = []
    for e in range(len(lmask)):
        if not lmask[e]:
            continue
        lines.append(_edge_line(int(li[e]), int(lj[e]), lR[e], lp[e], linfo[e]))
        # edge order in the file: n-1 odometry edges first, then loops
        kernel_lines.append(
            f"{n - 1 + n_loops} {loop_kernel[0]} {loop_kernel[1]:.9g}"
        )
        n_loops += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(path + ".kernels", "w") as f:
        f.write("\n".join(kernel_lines) + ("\n" if kernel_lines else ""))
    return n


def import_g2o(
    path: str,
    keyframe_capacity: int | None = None,
    loop_capacity: int | None = None,
    dtype=torch.float32,
    device="cpu",
) -> PoseGraph:
    """Parse a g2o text file back into a PoseGraph. Consecutive
    (i, i+1) EDGE_SE3:QUAT lines rebuild the odometry chain; every other
    SE3 edge becomes a loop edge. Unknown line types are skipped (a file
    written by the reference carries its custom vertex/edge types too)."""
    verts: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    chain: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    loops: list[tuple[int, int, np.ndarray, np.ndarray, np.ndarray]] = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                i = int(tok[1])
                v = np.asarray(list(map(float, tok[2:9])))
                verts[i] = (_quat_to_rot(v[3:7]), v[:3])
            elif tok[0] == "EDGE_SE3:QUAT":
                i, j = int(tok[1]), int(tok[2])
                v = np.asarray(list(map(float, tok[3:10])))
                info = _info_in(np.asarray(list(map(float, tok[10:31]))))
                Rm, pm = _quat_to_rot(v[3:7]), v[:3]
                if j == i + 1:
                    chain[j] = (Rm, pm, info)
                else:
                    loops.append((i, j, Rm, pm, info))
    n = max(verts) + 1 if verts else 0
    if sorted(verts) != list(range(n)):
        raise ValueError(f"{path}: vertex ids are not dense 0..{n - 1}")
    K = keyframe_capacity or max(n, 2)
    L = loop_capacity or max(len(loops), 1)
    if n > K or len(loops) > L:
        raise ValueError(f"{path}: {n} nodes / {len(loops)} loops exceed capacity {K}/{L}")
    R = np.stack([verts[i][0] for i in range(n)]) if n else np.zeros((0, 3, 3))
    p = np.stack([verts[i][1] for i in range(n)]) if n else np.zeros((0, 3))
    rel_R = np.tile(np.eye(3), (n, 1, 1))
    rel_p = np.zeros((n, 3))
    oinfo = np.tile(np.eye(6), (n, 1, 1))
    for j, (Rm, pm, info) in chain.items():
        rel_R[j], rel_p[j], oinfo[j] = Rm, pm, info
    g = PoseGraph.create(K, L, dtype=dtype, device="cpu")

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    g.node_mask[:n] = True
    g.R[:n], g.p[:n] = t(R), t(p)
    g.odom_rel_R[:n], g.odom_rel_p[:n], g.odom_info[:n] = t(rel_R), t(rel_p), t(oinfo)
    for e, (i, j, Rm, pm, info) in enumerate(loops):
        g.loop_i[e], g.loop_j[e] = i, j
        g.loop_rel_R[e], g.loop_rel_p[e], g.loop_info[e] = t(Rm), t(pm), t(info)
        g.loop_mask[e] = True
    return PoseGraph(**{name: getattr(g, name).to(device) for name in g.__dataclass_fields__})


def dump_session_graph(engine, directory: str) -> str | None:
    """Engine hook: write `graph.g2o` (+ kernel sidecar) into a checkpoint
    or output directory; returns the path (None if the session has no
    graph yet)."""
    st = engine.state
    if st.graph is None:
        return None
    os.makedirs(directory, exist_ok=True)
    out = os.path.join(directory, "graph.g2o")
    export_g2o(st.graph, out)
    return out
