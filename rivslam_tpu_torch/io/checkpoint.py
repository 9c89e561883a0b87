"""Checkpoint / resume, DumpGraph/LoadGraph service parity (port of
``rivslam_tpu/io/checkpoint.py``), in the JAX package's format: a session
dumped by either engine resumes in the other.

A checkpoint directory holds ``manifest.json`` (version 1: counters, the
keyframes' stamps, travel and barometer readings, the GPS origin, which
states exist) and one ``.npz`` per state, whose arrays ``leaf_0``,
``leaf_1``, ... are the state's tensors in ``jax.tree.flatten`` order: the
field order of each dataclass, nested dataclasses in place, a ``None``
field giving no leaf. That order, for the states the Engine carries:

    odometry.npz, OdometryState           0 target.xyz [N,3]   1 target.mask [N]
        2 target.cov [N,3,3]   3 keyframe_pose [4,4]   4 prev_trans [4,4]
        5 egovel_trans [3]   6 last_time []   7 accum_distance []
        8 keyframe_index [] int32
    odometry.npz, SubmapOdometryState (scan-to-map)   0-8 base, as above
        9 prev_trans_s2m [4,4]   10 keyframe_pose_s2m [4,4]
        11 kf_xyz [S,N,3]   12 kf_mask [S,N]   13 kf_pose [S,4,4]
        14 kf_valid [S]   15 target.xyz [S*N,3]   16 target.mask [S*N]
        17 target.cov [S*N,3,3]
    backend.npz, BackendState   0 frame_mask [W]   1 stamps [W]
        2 odom_R [W,3,3]   3 odom_p [W,3]   4 xyz [W,N,3]   5 cloud_mask [W,N]
        6-10 nav: R, p, v, bg, ba   11-22 preint: dt, dR, dv, dp, dR_dbg,
        dV_dbg, dV_dba, dP_dbg, dP_dba, cov, bg, ba   23 preint_info [W,9,9]
        24 rel_R   25 rel_p   26 rel_info [W,6,6]   27 ego_vel   28 vel_info
        29 floor [W,4]   30 floor_valid [W]   31 trans_aftmapped [4,4]
    graph.npz, PoseGraph   0 R [K,3,3]   1 p   2 node_mask   3 odom_rel_R
        4 odom_rel_p   5 odom_info [K,6,6]   6 loop_i [L]   7 loop_j
        8 loop_rel_R   9 loop_rel_p   10 loop_info   11 loop_mask
        12 anchor_info [6,6]   13 gps_xyz [K,3]   14 gps_info [K,3]   15 gps_mask
    scdb.npz, ScanContextDB   0 desc [K,R,S]   1 ring_key   2 sector_key
        3 count []

``keyframes.npz`` (xyz, mask, odom), ``trajectory.npz`` (t, poses) and
``prev_loop.npz`` hold the host-side lists; ``graph.g2o`` is the graph as
g2o text (``io/g2o_io``). Arrays are read into the template state's dtypes
(the JAX package writes int32 indices where the port keeps int64) on the
Engine's device. A scan-to-map session loads as a SubmapOdometryState when
the Engine's configuration has scan-to-map on (the JAX package's loader
reads an OdometryState, the first 9 leaves, in every case).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

VERSION = 1


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a state in ``jax.tree.flatten`` order (see the module
    doc): dataclass fields in order, nested, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) for leaf in leaves(getattr(tree, f.name))]
    raise TypeError(f"not a state leaf: {type(tree).__name__}")


def unflatten(template, values: list[torch.Tensor]):
    """``template`` with its tensors replaced by ``values``, in order."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return next(it)
        return dataclasses.replace(t, **{f.name: build(getattr(t, f.name)) for f in dataclasses.fields(t)})

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def _save_state(path: str, tree) -> None:
    np.savez(path, **{f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves(tree))})


def _load_state(path: str, template, device):
    data = np.load(path)
    tl = leaves(template)
    if len(data.files) < len(tl):
        raise ValueError(f"{path}: {len(data.files)} arrays for a state of {len(tl)} leaves")
    return unflatten(template, [
        torch.as_tensor(data[f"leaf_{i}"]).to(device=device, dtype=t.dtype) for i, t in enumerate(tl)
    ])


def dump(engine, directory: str) -> None:
    """Serialize an Engine session (DumpGraph analogue). An asynchronous
    loop worker is drained first, so that no detection in flight is lost."""
    from rivslam_tpu_torch.io import g2o_io

    engine.drain_loops()
    os.makedirs(directory, exist_ok=True)
    st = engine.state
    manifest = {
        "version": VERSION,
        "frame_idx": st.frame_idx,
        "kf_count": st.kf_count,
        "last_loop_accum": st.last_loop_accum,
        "kf_stamps": list(map(float, st.kf_stamps)),
        "kf_accum": list(map(float, st.kf_accum)),
        # nan (no barometer) is not valid JSON: written as None
        "kf_alt": [None if np.isnan(a) else float(a) for a in st.kf_alt],
        "zero_utm": None if st.zero_utm is None else list(map(float, st.zero_utm)),
        "baro_zero": None if st.baro_zero is None else float(st.baro_zero),
        "gps_kf_since_solve": st.gps_kf_since_solve,
        "n_traj": len(st.trajectory),
        "has_odo": st.odo is not None,
        "has_backend": st.backend is not None,
        "has_graph": st.graph is not None,
        "has_prev_loop": st.prev_loop is not None,
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if st.odo is not None:
        _save_state(os.path.join(directory, "odometry.npz"), st.odo)
    if st.backend is not None:
        _save_state(os.path.join(directory, "backend.npz"), st.backend)
    if st.graph is not None:
        _save_state(os.path.join(directory, "graph.npz"), st.graph)
        _save_state(os.path.join(directory, "scdb.npz"), st.scdb)
        # the graph as standard g2o text (+ robust-kernel sidecar), the
        # reference's DumpGraph output format (graph_slam.cpp:512-538)
        g2o_io.export_g2o(st.graph, os.path.join(directory, "graph.g2o"))
    if st.kf_clouds:
        np.savez(
            os.path.join(directory, "keyframes.npz"),
            xyz=np.stack([x.cpu().numpy() for x, _ in st.kf_clouds]),
            mask=np.stack([m.cpu().numpy() for _, m in st.kf_clouds]),
            odom=np.stack([T.cpu().numpy() for T in st.kf_odom]),
        )
    if st.trajectory:
        np.savez(
            os.path.join(directory, "trajectory.npz"),
            t=np.asarray([t for t, _ in st.trajectory]),
            poses=np.stack([T for _, T in st.trajectory]),
        )
    if st.prev_loop is not None:
        np.savez(os.path.join(directory, "prev_loop.npz"),
                 **{k: st.prev_loop[k].cpu().numpy() for k in ("odom_i", "odom_j", "T_lc")})


def load(engine, directory: str) -> None:
    """Restore a dumped session into an Engine (LoadGraph analogue). The
    Engine must have the configuration and dtype of the dumped session."""
    from rivslam_tpu_torch.backend import slam
    from rivslam_tpu_torch.frontend import apdgicp, odometry, scan2map
    from rivslam_tpu_torch.loop import global_graph, scancontext

    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("version") != VERSION:
        raise ValueError(f"unsupported checkpoint version {manifest.get('version')!r}")
    st = engine.state
    c, dtype, dev = engine.cfg, engine.dtype, engine.device
    st.frame_idx = manifest["frame_idx"]
    st.kf_count = manifest["kf_count"]
    st.last_loop_accum = manifest["last_loop_accum"]
    st.kf_stamps = manifest["kf_stamps"]
    st.kf_accum = manifest["kf_accum"]
    # absent from manifests written before GPS support (tests/golden/ckpt_v1)
    st.kf_alt = [float("nan") if a is None else float(a)
                 for a in manifest.get("kf_alt", [None] * st.kf_count)]
    zu = manifest.get("zero_utm")
    st.zero_utm = None if zu is None else np.asarray(zu, np.float64)
    st.baro_zero = manifest.get("baro_zero")
    st.gps_kf_since_solve = manifest.get("gps_kf_since_solve", 0)

    if manifest["has_odo"]:
        path = os.path.join(directory, "odometry.npz")
        cap = np.load(path)["leaf_0"].shape[0]  # target.xyz [N,3]
        cloud = apdgicp.PreparedCloud(
            xyz=torch.zeros((cap, 3), dtype=dtype, device=dev),
            mask=torch.zeros(cap, dtype=torch.bool, device=dev),
            cov=torch.zeros((cap, 3, 3), dtype=dtype, device=dev),
        )
        if c.odometry.enable_scan_to_map:
            template = scan2map.init_state(cloud, 0.0, c.odometry, dtype=dtype)
        else:
            template = odometry.init_state(cloud, 0.0, dtype=dtype)
        st.odo = _load_state(path, template, dev)
    if manifest["has_backend"]:
        template = slam.init_state(c.backend, c.imu, 8, dtype, dev)  # shapes come from the file
        st.backend = _load_state(os.path.join(directory, "backend.npz"), template, dev)
    if manifest["has_graph"]:
        template = global_graph.PoseGraph.create(c.loop.keyframe_capacity, c.loop.loop_capacity,
                                                 dtype=dtype, device=dev)
        st.graph = _load_state(os.path.join(directory, "graph.npz"), template, dev)
        template = scancontext.ScanContextDB.create(c.loop, dtype=dtype, device=dev)
        st.scdb = _load_state(os.path.join(directory, "scdb.npz"), template, dev)
    kf_path = os.path.join(directory, "keyframes.npz")
    if os.path.exists(kf_path):
        data = np.load(kf_path)
        st.kf_clouds = [
            (torch.as_tensor(x).to(device=dev, dtype=dtype), torch.as_tensor(m).to(dev))
            for x, m in zip(data["xyz"], data["mask"])
        ]
        st.kf_odom = [torch.as_tensor(T).to(device=dev, dtype=dtype) for T in data["odom"]]
    traj_path = os.path.join(directory, "trajectory.npz")
    if os.path.exists(traj_path):
        data = np.load(traj_path)
        st.trajectory = [(float(t), P) for t, P in zip(data["t"], data["poses"])]
    pl_path = os.path.join(directory, "prev_loop.npz")
    if os.path.exists(pl_path):
        data = np.load(pl_path)
        st.prev_loop = {k: torch.as_tensor(data[k]).to(device=dev, dtype=dtype)
                        for k in ("odom_i", "odom_j", "T_lc")}
