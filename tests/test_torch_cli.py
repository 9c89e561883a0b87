"""The port's command line, ``python -m rivslam_tpu_torch``, on the CPU
(``--device cpu``), on a tiny sequence at capacity 256: it writes the TUM
trajectory that the Engine and ``datasets.replay`` give in process with the
same seed, from a ``.npz``, a ``.rivbin`` and a ROS1 bag alike; a session
dumped with ``--ckpt`` (the asynchronous loop worker on) resumes with
``--resume``; the diagnostics; ``--device-replay`` (the whole sequence
through ``Engine.replay_sequence``) from a ``.npz`` and a ``.rivbin``, with
its map and its refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

from rivslam_tpu_torch import __main__ as cli
from rivslam_tpu_torch import pipeline
from rivslam_tpu_torch.core.config import EngineConfig, RegistrationConfig
from rivslam_tpu_torch.io import checkpoint, datasets, synthetic, tum

CAP, IMU_CAP = 256, 32
COURSE = dict(seed=21, radius=8.0, omega=0.25, dt=0.15, n_frames=4, capacity=CAP,
              world_points=20000, extent=30.0)
ARGS = ["--capacity", str(CAP), "--imu-capacity", str(IMU_CAP), "--method", "FAST_GICP", "--device", "cpu"]


@pytest.fixture(scope="module")
def seq_file(tmp_path_factory):
    seq, _ = synthetic.simulate_sequence(**COURSE)
    path = tmp_path_factory.mktemp("cli") / "seq.npz"
    seq.save(str(path))
    return path, seq


def _in_process(seq):
    cfg = dataclasses.replace(EngineConfig(), registration=RegistrationConfig(method="FAST_GICP"))
    eng = pipeline.Engine(cfg, device="cpu")
    datasets.replay(eng, seq, CAP, IMU_CAP)
    return eng.trajectory()


def test_cli_writes_the_engines_trajectory(seq_file, tmp_path, capsys):
    path, seq = seq_file
    out = tmp_path / "traj.txt"
    assert cli.main(["--seq", str(path), "--out", str(out), "--map", str(tmp_path / "m.pcd"), *ARGS]) == 0
    ts, poses = _in_process(seq)
    tum.save_tum(str(tmp_path / "want.txt"), ts, poses)
    assert out.read_text() == (tmp_path / "want.txt").read_text()
    assert len(out.read_text().splitlines()) == COURSE["n_frames"]
    printed = capsys.readouterr().out
    assert "| stage |" in printed and "map points" in printed


def test_cli_rivbin_input_matches_npz(seq_file, tmp_path):
    path, _ = seq_file
    rb = tmp_path / "seq.rivbin"
    assert cli.main(["--seq", str(path), "--to-rivbin", str(rb)]) == 0
    for src, name in ((path, "npz.txt"), (rb, "rivbin.txt")):
        assert cli.main(["--seq", str(src), "--out", str(tmp_path / name), *ARGS]) == 0
    a, b = tum.load_tum(str(tmp_path / "npz.txt")), tum.load_tum(str(tmp_path / "rivbin.txt"))
    np.testing.assert_array_equal(a[0], b[0])
    # the container stores float32 targets, the .npz float64: the same frames
    np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-3)


def test_cli_async_checkpoint_and_resume(seq_file, tmp_path):
    """--async-loop with --ckpt dumps a session that --resume continues."""
    path, seq = seq_file
    ck = tmp_path / "ck"
    assert cli.main(["--seq", str(path), "--out", str(tmp_path / "a.txt"), "--async-loop",
                     "--ckpt", str(ck), "--viz", str(tmp_path / "v"), *ARGS]) == 0
    assert (ck / "manifest.json").exists() and (ck / "graph.g2o").exists()
    assert (tmp_path / "v_traj.ply").exists()
    assert cli.main(["--seq", str(path), "--out", str(tmp_path / "b.txt"), "--resume", str(ck), *ARGS]) == 0
    ts, _ = tum.load_tum(str(tmp_path / "b.txt"))
    assert len(ts) == 2 * COURSE["n_frames"]  # the dumped frames, then the replay's
    eng = pipeline.Engine(dataclasses.replace(EngineConfig(), registration=RegistrationConfig(method="FAST_GICP")),
                          device="cpu")
    checkpoint.load(eng, str(ck))
    assert eng.state.frame_idx == COURSE["n_frames"]


def test_cli_bag_input(tmp_path):
    """A ROS1 bag converts next to itself, then replays."""
    from test_rosbag1 import ser_imu, ser_pointcloud, write_bag

    seq, _ = synthetic.simulate_sequence(**COURSE)
    msgs = []
    for i in range(seq.num_frames):
        f = seq.frame(i)
        msgs.append(("/radar_enhanced_pcl", "sensor_msgs/PointCloud", 100.0 + f["stamp"],
                     ser_pointcloud(100.0 + f["stamp"], f["xyz"], f["doppler"], f["intensity"])))
    for t, a, g in zip(seq.imu_stamps, seq.imu_acc, seq.imu_gyr):
        msgs.append(("/vectornav/imu", "sensor_msgs/Imu", 100.0 + t, ser_imu(100.0 + t, a, g)))
    bag = tmp_path / "run.bag"
    write_bag(str(bag), sorted(msgs, key=lambda m: m[2]))
    assert cli.main(["--seq", str(bag), "--out", str(tmp_path / "t.txt"), *ARGS]) == 0
    assert (tmp_path / "run.rivseq.npz").exists()
    ts, poses = tum.load_tum(str(tmp_path / "t.txt"))
    assert len(ts) == seq.num_frames and np.isfinite(poses).all()


def test_cli_histogram_and_what_is_not_ported(seq_file, tmp_path, capsys):
    """The histogram; and --device-replay, which earlier slices refused,
    writes one pose per frame (the replay's, tests/test_torch_replay.py
    holds it to process_frame)."""
    path, _ = seq_file
    assert cli.main(["--seq", str(path), "--histogram", "--device", "cpu"]) == 0
    assert "total sampled points" in capsys.readouterr().out
    out = tmp_path / "replay.txt"
    assert cli.main(["--seq", str(path), "--out", str(out), "--device-replay", *ARGS]) == 0
    ts, poses = tum.load_tum(str(out))
    assert len(ts) == COURSE["n_frames"] and np.isfinite(poses).all()
    assert "frames/s" in capsys.readouterr().err


def _replayed(seq):
    cfg = dataclasses.replace(EngineConfig(), registration=RegistrationConfig(method="FAST_GICP"))
    eng = pipeline.Engine(cfg, device="cpu")
    rep = eng.replay_sequence(datasets.stack_sequence(seq, CAP, IMU_CAP))
    return seq.frame_stamps, rep


def test_cli_device_replay(seq_file, tmp_path, capsys):
    """--device-replay from a .rivbin writes the in-process replay's
    trajectory and the keyframes' map; it refuses --resume and skips --ckpt
    and --viz with the reference's messages."""
    path, seq = seq_file
    rb = tmp_path / "seq.rivbin"
    assert cli.main(["--seq", str(path), "--to-rivbin", str(rb)]) == 0
    out, pcd = tmp_path / "t.txt", tmp_path / "m.pcd"
    assert cli.main(["--seq", str(rb), "--out", str(out), "--map", str(pcd), "--device-replay",
                     "--ckpt", str(tmp_path / "ck"), "--viz", str(tmp_path / "v"), *ARGS]) == 0
    captured = capsys.readouterr()
    assert "--ckpt needs keyframe state" in captured.err and "--viz needs keyframe state" in captured.err
    assert "map points" in captured.out and pcd.exists() and not (tmp_path / "ck").exists()
    ts, rep = _replayed(seq)
    tum.save_tum(str(tmp_path / "want.txt"), ts, rep["pose"])
    assert out.read_text() == (tmp_path / "want.txt").read_text()
    with pytest.raises(SystemExit):
        cli.main(["--seq", str(path), "--out", str(out), "--device-replay", "--resume", str(tmp_path), *ARGS])
    assert "cannot continue a --resume'd session" in capsys.readouterr().err


def test_cli_refuses_a_missing_card(seq_file, tmp_path, monkeypatch):
    """The default device is the card; without one the CLI raises, it does
    not fall back to the CPU."""
    path, _ = seq_file
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--seq", str(path), "--out", str(tmp_path / "t.txt")])
