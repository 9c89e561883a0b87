"""PyTorch port foundations against the JAX package: configuration, presets,
Lie-group math, point clouds, the synthetic data generator and the state
converters. Inputs are numpy arrays from fixed seeds, fed to both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shared_cache  # noqa: F401  (one torch thread per test process)

from rivslam_tpu import presets as ref_presets
from rivslam_tpu.core import config as ref_config
from rivslam_tpu.core import lie as ref_lie
from rivslam_tpu.core import pointcloud as ref_pc
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu_torch import convert, presets
from rivslam_tpu_torch.core import config, lie, pointcloud
from rivslam_tpu_torch.core.device import resolve
from rivslam_tpu_torch.io import synthetic

CONFIG_CLASSES = [
    name for name, obj in vars(ref_config).items()
    if isinstance(obj, type) and dataclasses.is_dataclass(obj)
]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_and_defaults_equal(name):
    ref_cls, cls = getattr(ref_config, name), getattr(config, name)
    ref_fields = [(f.name, f.type) for f in dataclasses.fields(ref_cls)]
    assert [(f.name, f.type) for f in dataclasses.fields(cls)] == ref_fields
    assert dataclasses.asdict(cls()) == dataclasses.asdict(ref_cls())


def test_config_default_tree_and_properties():
    assert dataclasses.asdict(config.DEFAULT) == dataclasses.asdict(ref_config.DEFAULT)
    assert config.ReveConfig().ransac_iter == ref_config.ReveConfig().ransac_iter
    assert set(CONFIG_CLASSES) == {
        n for n, o in vars(config).items() if isinstance(o, type) and dataclasses.is_dataclass(o)
    }


@pytest.mark.parametrize("name", ref_presets.names())
def test_presets_equal(name):
    assert presets.names() == ref_presets.names()
    assert dataclasses.asdict(presets.get(name)) == dataclasses.asdict(ref_presets.get(name))


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        presets.get("no-such-dataset")


# ---- Lie-group math: float64 through both packages, agreement to 1e-6 -------


def _rotvecs(seed, n=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)) * 1.2
    w[0] = 0.0
    w[1] = [1e-9, 0.0, 0.0]  # Taylor branch
    w[2] = [np.pi - 1e-3, 0.0, 0.0]  # near pi
    return w


def _lie_inputs(name, seed=3):
    rng = np.random.default_rng(seed)
    w = _rotvecs(seed)
    R = np.asarray(ref_lie.so3_exp(jnp.asarray(w)))
    xi = rng.normal(size=(32, 6)) * 0.8
    T = np.asarray(ref_lie.se3_exp(jnp.asarray(xi)))
    return {
        "hat": (w,),
        "so3_exp": (w,),
        "so3_log": (R,),
        "se3_matrix": (R, rng.normal(size=(64, 3))),
        "se3_exp": (xi,),
        "se3_inverse": (T,),
        "transform_points": (T[:4], rng.normal(size=(4, 50, 3)) * 10),
        "rotation_angle": (R,),
    }[name]


@pytest.mark.parametrize(
    "name",
    ["hat", "so3_exp", "so3_log", "se3_matrix", "se3_exp", "se3_inverse",
     "transform_points", "rotation_angle"],
)
def test_lie_matches_reference(name):
    args = _lie_inputs(name)
    want = np.asarray(getattr(ref_lie, name)(*map(jnp.asarray, args)))
    got = getattr(lie, name)(*map(torch.tensor, args)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_lie_float32_stays_float32():
    w = torch.as_tensor(_rotvecs(5), dtype=torch.float32)
    T = lie.se3_matrix(lie.so3_exp(w), w)
    assert T.dtype == torch.float32 and T.shape == (64, 4, 4)


# ---- point clouds, device policy and converters ------------------------------


def test_radar_cloud_from_numpy_and_masked_xyz():
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(200, 3)) * 20
    dop, inten = rng.normal(size=200), rng.uniform(size=200)
    ref = ref_pc.RadarCloud.from_numpy(xyz, 256, doppler=dop, intensity=inten, dtype=jnp.float32)
    got = pointcloud.RadarCloud.from_numpy(xyz, 256, doppler=dop, intensity=inten, device="cpu")
    for f in ("xyz", "doppler", "intensity", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(
        pointcloud.masked_xyz(got).numpy(), np.asarray(ref_pc.masked_xyz(ref))
    )
    assert got.capacity == 256 and int(got.count()) == 200
    assert pointcloud.SENTINEL == ref_pc.SENTINEL


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve("cuda")
    assert resolve("cpu") == torch.device("cpu")


def test_convert_carries_state_across():
    rng = np.random.default_rng(2)
    cloud = ref_pc.RadarCloud.from_numpy(rng.normal(size=(50, 3)), 64)
    got = convert.radar_cloud(
        np.asarray(cloud.xyz), np.asarray(cloud.doppler), np.asarray(cloud.intensity),
        np.asarray(cloud.mask), device="cpu",
    )
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(cloud.xyz))
    assert got.mask.dtype == torch.bool
    cov = rng.normal(size=(64, 3, 3)).astype(np.float32)
    pc = convert.prepared_cloud(np.asarray(cloud.xyz), np.asarray(cloud.mask), cov, device="cpu")
    np.testing.assert_array_equal(pc.cov.numpy(), cov)
    cfg = convert.registration_config(
        dataclasses.asdict(ref_config.RegistrationConfig(covariance_method="RBF"))
    )
    assert cfg == config.RegistrationConfig(covariance_method="RBF")
    assert convert.guess(np.eye(4), device="cpu").dtype == torch.float32
    with pytest.raises(ValueError):
        convert.guess(np.eye(3), device="cpu")


# ---- synthetic data: the numpy copy draws the reference's numbers ----------


def test_make_world_and_observe_identical():
    w_ref = ref_syn.make_world(np.random.default_rng(4), n_points=3000)
    w = synthetic.make_world(np.random.default_rng(4), n_points=3000)
    np.testing.assert_array_equal(w, w_ref)
    T = np.eye(4)
    T[:3, 3] = [1.0, -2.0, 2.0]
    kw = dict(capacity=512, noise=0.01, fov_deg=60, sensor_vel_world=np.array([1.0, 0.5, 0.0]),
              range_noise_rel=0.002, az_noise_deg=0.3, el_noise_deg=0.3)
    ref = ref_syn.observe(w_ref, T, np.random.default_rng(5), dtype=jnp.float32, **kw)
    got = synthetic.observe(w, T, np.random.default_rng(5), device="cpu", **kw)
    for f in ("xyz", "doppler", "intensity", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))


def test_simulated_frames_identical():
    kw = dict(seed=3, n_frames=4, capacity=256, radius=14.0, omega=0.22, world_points=4000)
    seq, _ = ref_syn.simulate_sequence(**kw)
    got, _ = synthetic.simulate_sequence(**kw)
    np.testing.assert_array_equal(got.gt_poses, seq.gt_poses)
    for i in range(got.num_frames):
        f, ref = got.frame(i), seq.frame(i)
        assert f["stamp"] == ref["stamp"]
        for k in ("xyz", "doppler", "intensity"):
            np.testing.assert_array_equal(f[k], ref[k])


def test_load_pairs_follow_bench_protocol():
    src_xyz, src_mask, tgt_xyz, tgt_mask, rel = synthetic.load_pairs(3, 256, device="cpu")
    seq, _ = ref_syn.simulate_sequence(seed=0, n_frames=4, capacity=256, radius=14.0, omega=0.22)
    for i in range(1, 4):
        src = ref_pc.RadarCloud.from_numpy(seq.frame(i)["xyz"], 256)
        tgt = ref_pc.RadarCloud.from_numpy(seq.frame(i - 1)["xyz"], 256)
        np.testing.assert_array_equal(src_xyz[i - 1].numpy(), np.asarray(src.xyz))
        np.testing.assert_array_equal(src_mask[i - 1].numpy(), np.asarray(src.mask))
        np.testing.assert_array_equal(tgt_xyz[i - 1].numpy(), np.asarray(tgt.xyz))
        np.testing.assert_array_equal(tgt_mask[i - 1].numpy(), np.asarray(tgt.mask))
        np.testing.assert_allclose(
            rel[i - 1], np.linalg.inv(seq.gt_poses[i - 1]) @ seq.gt_poses[i], rtol=0, atol=0
        )
