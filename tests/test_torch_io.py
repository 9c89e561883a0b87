"""The port's I/O surface against the JAX package's, on the CPU.

- TUM, PCD, g2o, PLY/PGM and ``.rivbin`` writers: the same bytes from the
  same inputs; the readers give back the same arrays.
- ROS1 bags (uncompressed, bz2 and LZ4 chunks) built here, as
  tests/test_rosbag1.py builds them, parsed and converted by both packages.
- The frame converters, ``stack_sequence`` / ``stack_native_sequence``,
  the filters and quaternion helpers, and the map assembly.
- Checkpoints in the JAX package's format: the port loads the JAX-written
  ``tests/golden/ckpt_v1``; a JAX dump resumes in the port and both engines
  continue a few frames (the JAX engine's RANSAC draws injected) to within
  1e-4 m in float64; a port dump loads into the JAX engine.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

from rivslam_tpu import pipeline as ref_pipeline
from rivslam_tpu import presets as ref_presets
from rivslam_tpu.backend import map as ref_map
from rivslam_tpu.core import lie as ref_lie
from rivslam_tpu.core.pointcloud import RadarCloud as RefCloud
from rivslam_tpu.eval import viz as ref_viz
from rivslam_tpu.io import checkpoint as ref_checkpoint
from rivslam_tpu.io import datasets as ref_datasets
from rivslam_tpu.io import g2o_io as ref_g2o
from rivslam_tpu.io import rosbag1 as ref_rosbag1
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu.io import tum as ref_tum
from rivslam_tpu.loop.global_graph import PoseGraph as RefPoseGraph
from rivslam_tpu.ops import filters as ref_filters
from rivslam_tpu.runtime import native as ref_native
from rivslam_tpu_torch import pipeline, presets
from rivslam_tpu_torch.backend import map as map_mod
from rivslam_tpu_torch.core import config as port_config
from rivslam_tpu_torch.core import lie
from rivslam_tpu_torch.core.pointcloud import RadarCloud
from rivslam_tpu_torch.eval import viz
from rivslam_tpu_torch.io import checkpoint, datasets, g2o_io, lz4f, rosbag1, synthetic, tum
from rivslam_tpu_torch.loop.global_graph import PoseGraph
from rivslam_tpu_torch.ops import filters
from rivslam_tpu_torch.runtime import native

from _golden_gen import golden_config
from test_rosbag1 import make_messages, ser_pointcloud2, ser_radar_scan, write_bag
from test_torch_engine import CAP, COURSE, IMU_CAP, _cfg

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "ckpt_v1")
RESUME_ATOL = 1e-4


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        w = rng.normal(size=3) * (0.5 if i % 3 else 3.0)  # some past pi/2
        T[i, :3, :3] = lie.so3_exp(torch.as_tensor(w)).numpy()
        T[i, :3, 3] = rng.normal(size=3) * 10
    return T


def _same_bytes(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


# ---- writers: byte equality -------------------------------------------------------


def test_tum_bytes_match_reference(tmp_path):
    ts, T = np.arange(20) * 0.1 + 1000.0, _poses(20)
    tum.save_tum(str(tmp_path / "port.txt"), ts, T)
    ref_tum.save_tum(str(tmp_path / "ref.txt"), ts, T)
    _same_bytes(tmp_path / "port.txt", tmp_path / "ref.txt")
    got, want = tum.load_tum(str(tmp_path / "ref.txt")), ref_tum.load_tum(str(tmp_path / "ref.txt"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-15)
    np.testing.assert_allclose(got[1], T, rtol=0, atol=1e-8)


def test_pcd_bytes_match_reference(tmp_path):
    pts = np.random.default_rng(1).normal(size=(300, 3)) * 20
    utm = np.array([365000.25, 143000.5, 12.0])
    for name, mod in (("port", map_mod), ("ref", ref_map)):
        mod.save_map_pcd(str(tmp_path / f"{name}.pcd"), pts, zero_utm=utm, apply_utm_offset=True)
    _same_bytes(tmp_path / "port.pcd", tmp_path / "ref.pcd")
    _same_bytes(tmp_path / "port.pcd.utm", tmp_path / "ref.pcd.utm")
    np.testing.assert_array_equal(map_mod.load_pcd(str(tmp_path / "ref.pcd")),
                                  ref_map.load_pcd(str(tmp_path / "ref.pcd")))


def _graphs(K=12, L=4, n=9):
    rng = np.random.default_rng(2)
    T = _poses(K, seed=3)
    rel = _poses(K, seed=4)
    info = rng.normal(size=(K, 6, 6))
    info = info @ np.swapaxes(info, 1, 2) + 6 * np.eye(6)
    g = PoseGraph.create(K, L, dtype=torch.float64)
    g.R[:n], g.p[:n] = torch.as_tensor(T[:n, :3, :3]), torch.as_tensor(T[:n, :3, 3])
    g.node_mask[:n] = True
    g.odom_rel_R[:n], g.odom_rel_p[:n] = torch.as_tensor(rel[:n, :3, :3]), torch.as_tensor(rel[:n, :3, 3])
    g.odom_info[:n] = torch.as_tensor(info[:n])
    for e, (i, j) in enumerate([(0, 7), (2, 8)]):
        g.loop_i[e], g.loop_j[e], g.loop_mask[e] = i, j, True
        g.loop_rel_R[e], g.loop_rel_p[e] = torch.as_tensor(rel[e, :3, :3]), torch.as_tensor(rel[e, :3, 3])
        g.loop_info[e] = torch.as_tensor(info[e])
    ref = RefPoseGraph(**{f.name: jnp.asarray(getattr(g, f.name).numpy())
                          for f in dataclasses.fields(RefPoseGraph)})
    return g, ref


def test_g2o_bytes_match_reference(tmp_path):
    g, ref = _graphs()
    assert g2o_io.export_g2o(g, str(tmp_path / "port.g2o")) == ref_g2o.export_g2o(ref, str(tmp_path / "ref.g2o")) == 9
    _same_bytes(tmp_path / "port.g2o", tmp_path / "ref.g2o")
    _same_bytes(tmp_path / "port.g2o.kernels", tmp_path / "ref.g2o.kernels")
    got = g2o_io.import_g2o(str(tmp_path / "ref.g2o"), 12, 4, dtype=torch.float64)
    want = ref_g2o.import_g2o(str(tmp_path / "ref.g2o"), 12, 4, dtype=jnp.float64)
    for f in dataclasses.fields(RefPoseGraph):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


def _seq(n_frames=12, seed=2):
    """tests/test_native_runtime.py's sequence, as the port's container."""
    rng = np.random.default_rng(seed)
    frames, t = [], 0.0
    for _ in range(n_frames):
        n = rng.integers(20, 120)
        frames.append(dict(stamp=t, xyz=rng.normal(size=(n, 3)), doppler=rng.normal(size=n),
                           intensity=rng.uniform(5, 30, size=n)))
        t += 0.1
    imu_t = np.arange(0.0, t, 0.01)
    return datasets.RadarSequence.from_frames(frames, imu_t, rng.normal(size=(len(imu_t), 3)),
                                              rng.normal(size=(len(imu_t), 3)))


@pytest.mark.parametrize("compress", [False, True])
def test_rivbin_bytes_match_reference(tmp_path, compress):
    seq = _seq()
    native.write_rivbin(str(tmp_path / "port.rivbin"), seq, compress=compress)
    ref_native.write_rivbin(str(tmp_path / "ref.rivbin"), seq, compress=compress)
    _same_bytes(tmp_path / "port.rivbin", tmp_path / "ref.rivbin")
    ns, rns = native.NativeSequence(str(tmp_path / "ref.rivbin")), ref_native.NativeSequence(str(tmp_path / "ref.rivbin"))
    assert ns.num_frames == rns.num_frames == 12 and ns.format_version == (2 if compress else 1)
    for i in (0, 5, 11):
        for a, b in zip(ns.read_frame(i, 128), rns.read_frame(i, 128)):
            np.testing.assert_array_equal(a, b)
    got = datasets.stack_native_sequence(ns, capacity=128, imu_capacity=16)
    want = ref_datasets.stack_native_sequence(rns, capacity=128, imu_capacity=16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    loader = native.PrefetchLoader(ns, capacity=128)
    items = [loader.next_aligned(16) for _ in range(12)]
    assert loader.next_aligned(16) is None and [it[0] for it in items] == list(range(12))
    loader.close()
    ns.close()
    rns.close()


def test_stack_sequence_matches_reference():
    seq = _seq()
    ref = ref_datasets.RadarSequence(**dataclasses.asdict(seq))
    got = datasets.stack_sequence(seq, capacity=100, imu_capacity=16)
    want = ref_datasets.stack_sequence(ref, capacity=100, imu_capacity=16)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


# ---- bags ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [None, "bz2", "lz4"])
def test_rosbag_conversion_matches_reference(tmp_path, compression):
    path = str(tmp_path / "eagle.bag")
    write_bag(path, make_messages(np.random.default_rng(0)), compression=compression)
    got = list(rosbag1.read_messages(path))
    assert [(t, ty, s) for t, ty, s, _ in got] == [(t, ty, s) for t, ty, s, _ in ref_rosbag1.read_messages(path)]
    seq = datasets.convert_rosbag(path, str(tmp_path / "port.npz"))
    ref_datasets.convert_rosbag(path, str(tmp_path / "ref.npz"))
    a, b = datasets.RadarSequence.load(str(tmp_path / "port.npz")), ref_datasets.RadarSequence.load(str(tmp_path / "ref.npz"))
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if y is not None:
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    assert seq is None and a.num_frames == 3 and a.baro_at(100.1) == 151.0


def test_pointcloud2_and_scan_extended_match_reference(tmp_path):
    rng = np.random.default_rng(4)
    xyz, dop, power = rng.normal(size=(40, 3)) * 10, rng.normal(size=40), rng.uniform(1, 20, 40)
    r_, az, el = rng.uniform(2, 50, 20), rng.uniform(-1, 1, 20), rng.uniform(-0.5, 0.5, 20)
    msgs = [("/radar", "sensor_msgs/PointCloud2", 5.0, ser_pointcloud2(5.0, xyz, dop, power)),
            ("/radar2", "msgs_radar/RadarScanExtended", 6.0,
             ser_radar_scan(6.0, r_, az, el, rng.normal(size=20), rng.uniform(5, 20, 20)))]
    path = str(tmp_path / "mixed.bag")
    write_bag(path, msgs)
    got = list(rosbag1.read_messages(path))
    for parse in ("parse_pointcloud2", "parse_radar_scan_extended"):
        body = got[0 if parse == "parse_pointcloud2" else 1][3]
        _assert_same(getattr(rosbag1, parse)(body), getattr(ref_rosbag1, parse)(body))
    for topic in ("/radar", "/radar2"):
        seq = rosbag1.convert_bag(path, str(tmp_path / "p.npz"), radar_topic=topic)
        ref = ref_rosbag1.convert_bag(path, str(tmp_path / "r.npz"), radar_topic=topic)
        np.testing.assert_array_equal(seq.xyz, ref.xyz)
        np.testing.assert_array_equal(seq.intensity, ref.intensity)


def _assert_same(a, b):
    """Equal parse results: dicts key by key, arrays bitwise, stamp objects
    field by field."""
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_same(a[k], b[k])
    elif isinstance(b, (np.ndarray, list, tuple, float, int, str, bytes)):
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a).__name__ == type(b).__name__ == "RosTime" and (a.sec, a.nsec) == (b.sec, b.nsec)


def test_lz4_frame_roundtrip():
    data = bytes(np.random.default_rng(5).integers(0, 4, 200000, dtype=np.uint8))
    frame = lz4f.compress_frame(data)
    assert lz4f.decompress_frame(frame) == data
    block = native.lz4_block_compress(data)
    assert lz4f.decompress_block(block, len(data)) == data == native.lz4_block_decompress(block, len(data))


# ---- converters, filters, quaternions, map ------------------------------------------------


def test_frame_converters_and_filters_match_reference():
    rng = np.random.default_rng(6)
    r_, az, el = rng.uniform(1, 60, 50), rng.uniform(-1, 1, 50), rng.uniform(-0.4, 0.4, 50)
    np.testing.assert_array_equal(datasets.targets_to_xyz(r_, az, el), ref_datasets.targets_to_xyz(r_, az, el))
    xyz, v, p = rng.normal(size=(50, 3)), rng.normal(size=50), rng.uniform(size=50)
    for a, b in ((datasets.eagle_channels_to_frame(xyz, v, p), ref_datasets.eagle_channels_to_frame(xyz, v, p)),
                 (datasets.hugin_fields_to_frame(*xyz.T, v, p), ref_datasets.hugin_fields_to_frame(*xyz.T, v, p))):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(
        filters.spherical_to_cartesian(*map(torch.as_tensor, (r_, az, el))).numpy(),
        np.asarray(ref_filters.spherical_to_cartesian(*map(jnp.asarray, (r_, az, el)))))
    pts = rng.normal(size=(300, 3)) * 30
    cl = RadarCloud.from_numpy(pts, 400, dtype=torch.float64, device="cpu")
    rcl = RefCloud.from_numpy(pts, 400, dtype=jnp.float64)
    np.testing.assert_array_equal(filters.distance_histogram(cl).numpy(), np.asarray(ref_filters.distance_histogram(rcl)))
    np.testing.assert_array_equal(filters.z_filter(cl, -5.0).mask.numpy(), np.asarray(ref_filters.z_filter(rcl, -5.0).mask))


def test_quaternion_helpers_match_reference():
    T = _poses(40, seed=7)
    R = T[:, :3, :3]
    q = lie.rot_to_quat(torch.as_tensor(R)).numpy()
    np.testing.assert_array_equal(q, np.asarray(ref_lie.rot_to_quat(jnp.asarray(R))))
    np.testing.assert_allclose(lie.quat_to_rot(torch.as_tensor(q)).numpy(),
                               np.asarray(ref_lie.quat_to_rot(jnp.asarray(q))), rtol=0, atol=1e-15)
    a, b = q[:20], q[20:]
    np.testing.assert_allclose(lie.quat_mul(*map(torch.as_tensor, (a, b))).numpy(),
                               np.asarray(ref_lie.quat_mul(jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-15)
    u = np.linspace(0, 1, 20)[:, None]
    np.testing.assert_allclose(lie.quat_slerp(*map(torch.as_tensor, (a, b, u))).numpy(),
                               np.asarray(ref_lie.quat_slerp(*map(jnp.asarray, (a, b, u)))), rtol=0, atol=1e-14)


def test_map_assembly_matches_reference():
    rng = np.random.default_rng(8)
    K, N = 4, 300
    xyz = rng.normal(size=(K, N, 3)) * 20
    mask = rng.uniform(size=(K, N)) > 0.2
    T = _poses(K, seed=9)
    got = map_mod.assemble_map(torch.as_tensor(xyz), torch.as_tensor(mask), torch.as_tensor(T), resolution=0.2)
    want = ref_map.assemble_map(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(T), resolution=0.2)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-12)


def test_ply_and_pgm_bytes_match_reference(tmp_path):
    rng = np.random.default_rng(10)
    pts, col = rng.normal(size=(50, 3)), rng.integers(0, 255, (50, 3)).astype(np.uint8)
    img = rng.integers(0, 255, (40, 20)).astype(np.uint8)
    for name, mod in (("port", viz), ("ref", ref_viz)):
        mod.save_ply(str(tmp_path / f"{name}.ply"), pts, col)
        mod.save_pgm(str(tmp_path / f"{name}.pgm"), img)
    _same_bytes(tmp_path / "port.ply", tmp_path / "ref.ply")
    _same_bytes(tmp_path / "port.pgm", tmp_path / "ref.pgm")


# ---- checkpoints in the JAX package's format -----------------------------------------------


def _port_cfg(ref_cfg):
    d = dataclasses.asdict(ref_cfg)
    return port_config.EngineConfig(**{
        f.name: type(getattr(port_config.EngineConfig(), f.name))(**d[f.name])
        for f in dataclasses.fields(port_config.EngineConfig)
    })


def test_golden_checkpoint_loads_and_resumes():
    """tests/golden/ckpt_v1, written by the JAX engine: the port's keyframe
    poses after the load equal the JAX engine's (float64), and the session
    goes on."""
    ref = ref_pipeline.Engine(golden_config(), dtype=jnp.float64)
    ref_checkpoint.load(ref, GOLDEN)
    eng = pipeline.Engine(_port_cfg(golden_config()), dtype=torch.float64, device="cpu")
    checkpoint.load(eng, GOLDEN)
    st = eng.state
    assert st.kf_count == 8 and len(st.kf_clouds) == 8 and len(st.trajectory) == 8
    np.testing.assert_array_equal(eng.optimized_keyframe_poses(), ref.optimized_keyframe_poses())
    for name in ("odo", "backend", "graph", "scdb"):
        got = checkpoint.leaves(getattr(st, name))
        want = jax.tree.leaves(getattr(ref.state, name))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=4000)
    T = np.eye(4)
    T[:3, 3] = [0.7 * 8, 0.0, 2.0]
    cl = synthetic.observe(world, T, rng, capacity=256, noise=0.005, dtype=torch.float64, device="cpu")
    zeros = (np.zeros(32), np.zeros((32, 3)), np.zeros((32, 3)), np.zeros(32, bool))
    out = eng.process_frame(cl, 0.25 * 8, *zeros)
    assert st.frame_idx == 9 and np.isfinite(out["pose"]).all()


def test_checkpoint_version_is_checked(tmp_path):
    import json
    import shutil

    shutil.copytree(GOLDEN, tmp_path / "ck")
    m = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    m["version"] = 99
    (tmp_path / "ck" / "manifest.json").write_text(json.dumps(m))
    eng = pipeline.Engine(_port_cfg(golden_config()), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="version"):
        checkpoint.load(eng, str(tmp_path / "ck"))


def _tail(seq, k):
    """The sequence from frame k on."""
    o = seq.offsets
    return dataclasses.replace(seq, frame_stamps=seq.frame_stamps[k:], offsets=o[k:] - o[k],
                               xyz=seq.xyz[o[k]:], doppler=seq.doppler[o[k]:], intensity=seq.intensity[o[k]:])


def _head(seq, k):
    o = seq.offsets
    return dataclasses.replace(seq, frame_stamps=seq.frame_stamps[:k], offsets=o[:k + 1],
                               xyz=seq.xyz[:o[k]], doppler=seq.doppler[:o[k]], intensity=seq.intensity[:o[k]])


def _key_draws(n):
    key, keys = jax.random.key(0), []
    for _ in range(n):
        key, k1 = jax.random.split(key)
        keys.append(k1)
    return keys


K_FRAMES, M_FRAMES = 3, 3


def test_jax_session_resumes_in_port(tmp_path):
    """A JAX dump after K_FRAMES frames loads into the port; the port and a
    JAX engine that loads the same dump go on for M_FRAMES frames, with the
    resumed JAX engine's draws injected, and stay within 1e-4 m."""
    seq, _ = ref_syn.simulate_sequence(**COURSE)
    ref_a = ref_pipeline.Engine(_cfg(ref_presets), dtype=jnp.float64, seed=0)
    ref_datasets.replay(ref_a, _head(seq, K_FRAMES), CAP, IMU_CAP)
    ref_checkpoint.dump(ref_a, str(tmp_path / "ck"))
    ref_b = ref_pipeline.Engine(_cfg(ref_presets), dtype=jnp.float64, seed=0)
    ref_checkpoint.load(ref_b, str(tmp_path / "ck"))
    want = ref_datasets.replay(ref_b, _tail(seq, K_FRAMES), CAP, IMU_CAP)
    keys = _key_draws(M_FRAMES)  # the resumed JAX engine's key chain starts anew

    def draws(frame_idx, shape):
        return np.asarray(jax.random.uniform(keys[frame_idx - K_FRAMES], shape))

    eng = pipeline.Engine(_cfg(presets), dtype=torch.float64, device="cpu", uniforms=draws)
    checkpoint.load(eng, str(tmp_path / "ck"))
    got = datasets.replay(eng, _tail(seq, K_FRAMES), CAP, IMU_CAP)
    assert [o["is_keyframe"] for o in got] == [o["is_keyframe"] for o in want]
    for key in ("pose", "odom"):
        np.testing.assert_allclose(np.stack([o[key] for o in got]), np.stack([o[key] for o in want]),
                                   rtol=0, atol=RESUME_ATOL)
    assert eng.state.frame_idx == K_FRAMES + M_FRAMES == len(eng.trajectory()[0])
    # the IMU-rate prediction from the last optimized state, as the JAX engine's
    rng = np.random.default_rng(11)
    imu = (np.full(IMU_CAP, 0.01), rng.normal(size=(IMU_CAP, 3)) * 0.1 + [0.0, 0.0, 9.81],
           rng.normal(size=(IMU_CAP, 3)) * 0.01, np.arange(IMU_CAP) < 20)
    np.testing.assert_allclose(eng.predict_highrate(*imu), ref_b.predict_highrate(*imu), rtol=0, atol=RESUME_ATOL)


def test_port_dump_loads_into_jax(tmp_path):
    """A port dump (scan-to-map state included) loads into the JAX engine
    leaf for leaf, and the JAX engine goes on from it."""
    seq, _ = synthetic.simulate_sequence(**dict(COURSE, n_frames=K_FRAMES))
    eng = pipeline.Engine(_cfg(presets), dtype=torch.float64, device="cpu")
    datasets.replay(eng, seq, CAP, IMU_CAP)
    checkpoint.dump(eng, str(tmp_path / "ck"))
    ref = ref_pipeline.Engine(_cfg(ref_presets), dtype=jnp.float64)
    ref_checkpoint.load(ref, str(tmp_path / "ck"))
    for name in ("odo", "backend", "graph", "scdb"):
        got, want = checkpoint.leaves(getattr(eng.state, name)), jax.tree.leaves(getattr(ref.state, name))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(eng.optimized_keyframe_poses(), ref.optimized_keyframe_poses())
    out = ref_datasets.replay(ref, _tail(ref_syn.simulate_sequence(**COURSE)[0], K_FRAMES), CAP, IMU_CAP)
    assert all(np.isfinite(o["pose"]).all() for o in out)
    # a scan-to-map session round-trips through the port's own loader
    cfg = dataclasses.replace(_cfg(presets), odometry=dataclasses.replace(
        _cfg(presets).odometry, enable_scan_to_map=True, max_submap_frames=2))
    e2 = pipeline.Engine(cfg, dtype=torch.float64, device="cpu")
    datasets.replay(e2, seq, CAP, IMU_CAP)
    checkpoint.dump(e2, str(tmp_path / "s2m"))
    e3 = pipeline.Engine(cfg, dtype=torch.float64, device="cpu")
    checkpoint.load(e3, str(tmp_path / "s2m"))
    for g, w in zip(checkpoint.leaves(e3.state.odo), checkpoint.leaves(e2.state.odo)):
        assert torch.equal(g, w)
    assert len(checkpoint.leaves(e3.state.odo)) == 18
