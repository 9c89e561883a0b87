"""The port's distributed layer (``rivslam_tpu_torch/dist/``, the sharded
block-Schur solve and ``Engine.replay_fleet(mesh=)``) against the JAX
package on the CPU, mirroring tests/test_dist.py and
tests/test_block_schur.py.

Every multi-rank check runs in one gloo world of 4 rank processes
(tests/torch_dist_world.py), started once per session through the shared
cache (tests/torch_shared_cache.py); each test holds one of its outputs
against the JAX package's local function, at the JAX tests' tolerances:
the registrations within 1e-9 (float64) with equal correspondence counts,
the PCG and block-Schur solves within 1e-6 in position and 1e-6 relative
in chi2, the batched odometry replay within 1e-9, the batched window
solves as tests/test_torch_backend.py holds one. The meshed fleet
(``data`` axis of 2) is bitwise the unmeshed one.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_shared_cache import release_xla_executables, shared  # noqa: F401

from rivslam_tpu.core import lie as ref_lie
from rivslam_tpu.core.config import BackendConfig as RefBackendConfig
from rivslam_tpu.core.config import OdometryConfig as RefOdometryConfig
from rivslam_tpu.core.config import RegistrationConfig as RefRegConfig
from rivslam_tpu.frontend import apdgicp as ref_apdgicp
from rivslam_tpu.frontend import replay_device as ref_replay_device
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu.loop import block_schur as ref_bs
from rivslam_tpu.loop import global_graph as ref_gg
from rivslam_tpu.solver import window as ref_win
from rivslam_tpu_torch.dist import mesh as mesh_mod
from rivslam_tpu_torch.io import datasets, synthetic

from test_torch_loop import _both_graphs, _graph_arrays
from test_window_solver import BIAS_INFO, build_problem

WORLD = 4
TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
REF_CFG = RefRegConfig(transformation_epsilon=5e-4)


def _scene():
    """tests/test_dist.py's scene: two 512-point float64 scans 0.36 m and
    0.04 rad apart, with the JAX package's exact covariances."""
    rng = np.random.default_rng(5)
    world = ref_syn.make_world(rng, n_points=6000)
    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 2.0]
    T_rel = np.asarray(ref_lie.se3_exp(jnp.asarray([0.0, 0.0, 0.04, 0.3, -0.2, 0.02])))
    tgt = ref_syn.observe(world, T0, rng, capacity=512, noise=0.01, dtype=jnp.float64)
    src = ref_syn.observe(world, T0 @ T_rel, rng, capacity=512, noise=0.01, dtype=jnp.float64)
    s = ref_apdgicp.estimate_covariances(src.xyz, src.mask, REF_CFG)
    t = ref_apdgicp.estimate_covariances(tgt.xyz, tgt.mask, REF_CFG)
    return ({f: np.asarray(getattr(c, f)) for f in ("xyz", "mask", "cov")} for c in (s, t))


def _replay_course():
    """tests/test_dist.py's odometry course: 5 frames of 256 points."""
    rng = np.random.default_rng(2)
    world = synthetic.make_world(rng, n_points=6000)
    times, poses, vels = synthetic.circular_trajectory(5, radius=10.0, dt=0.25, omega=0.3)
    clouds = [synthetic.observe(world, poses[i], rng, capacity=256, noise=0.01, sensor_vel_world=vels[i],
                                dtype=torch.float64, device="cpu") for i in range(5)]
    return dict(xyz=np.stack([c.xyz.numpy() for c in clouds]), mask=np.stack([c.mask.numpy() for c in clouds]),
                ego=np.stack([poses[i][:3, :3].T @ vels[i] for i in range(5)]), times=np.asarray(times))


def _graphs():
    """tests/test_torch_loop.py's drifted loop at capacity 64 (two loop
    edges, one interior), with its GPS and barometer priors ("schur") and
    without ("pcg": the sharded PCG's chi2 holds the priors' terms, the
    local one's does not)."""
    a, _ = _graph_arrays(K=64, L=8, n=48)
    plain = dict(a, gps_mask=np.zeros_like(a["gps_mask"]))
    return a, plain


def _tree_arrays(obj):
    """A (nested) dataclass of JAX arrays as a dict of numpy arrays."""
    return {f.name: _tree_arrays(v) if dataclasses.is_dataclass(v) else np.asarray(v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _windows():
    """Two sliding-window problems (tests/test_window_solver.py's, seeds 1
    and 2), as the JAX package's (state, factors) and as numpy trees stacked
    [p1, p2, p1, p2] for the world's data axis."""
    probs = [build_problem(noise_scale=1.0, init_perturb=0.05, seed=seed)[:2] for seed in (1, 2)]
    trees = [tuple(_tree_arrays(o) for o in pr) for pr in probs]

    def stack(*ts):
        return {k: stack(*(t[k] for t in ts)) if isinstance(ts[0][k], dict) else np.stack([t[k] for t in ts])
                for k in ts[0]}

    return probs, tuple(stack(*(trees[b % 2][i] for b in range(WORLD))) for i in range(2))


def _fleet_batch():
    stacked = [datasets.stack_sequence(
        synthetic.simulate_sequence(n_frames=3, seed=100 + i, radius=10.0, capacity=128)[0], 128, 16)
        for i in range(2)]
    return {k: np.stack([st[k] for st in stacked]) for k in stacked[0]}


def _run_world():
    src, tgt = _scene()
    graph, graph_plain = _graphs()
    _, windows = _windows()
    inp = dict(src=src, tgt=tgt, graph=graph, graph_plain=graph_plain, replay=_replay_course(),
               fleet=_fleet_batch(), windows=windows, bias_info=tuple(BIAS_INFO))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, k) for k in ("inputs.pkl", "out.pkl", "init")}
        with open(paths["inputs.pkl"], "wb") as f:
            pickle.dump(inp, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, TESTS, os.environ.get("PYTHONPATH", "")]))
        # each rank's output to a file: a rank blocked on a full pipe would
        # stall the world's collectives
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(WORLD)]
        procs = [subprocess.Popen([sys.executable, os.path.join(TESTS, "torch_dist_world.py"),
                                   paths["inputs.pkl"], paths["out.pkl"], str(r), str(WORLD), paths["init"]],
                                  env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
                 for r, log in enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=400)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            text = []
            for log in logs:
                log.seek(0)
                text.append(log.read()[-3000:])
                log.close()
        assert all(p.returncode == 0 for p in procs), "\n".join(text)
        with open(paths["out.pkl"], "rb") as f:
            out = pickle.load(f)
    return inp, out


@pytest.fixture(scope="module")
def world(request):
    return shared(request, "dist_world", _run_world)


def _ref_cloud(d):
    return ref_apdgicp.PreparedCloud(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.fixture(scope="module")
def ref_register(world):
    inp, _ = world
    return ref_apdgicp.register(_ref_cloud(inp["src"]), _ref_cloud(inp["tgt"]), jnp.eye(4, dtype=jnp.float64),
                                REF_CFG)


def test_mesh_construction_and_refusal(world):
    _, out = world
    assert out["mesh_shape"] == (2, 2) and out["mesh_names"] == ("data", "model")
    assert out["refused"] == f"need {2 * WORLD} ranks, have {WORLD}"
    assert "not divisible" in out["slice_refused"]
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh(1, 1)


def test_local_slice_and_gather_world_of_one(tmp_path):
    mesh_mod.init_world("gloo", 0, 1, str(tmp_path / "init"), timeout_s=30.0)
    try:
        m = mesh_mod.make_mesh(1, 1)
        x = torch.arange(12.0).reshape(6, 2)
        assert torch.equal(mesh_mod.local_slice(x, m, "data"), x)
        assert torch.equal(mesh_mod.gather(x, m, "data"), x)
        assert torch.equal(mesh_mod.all_sum(x, m.get_group("model")), x)
    finally:
        torch.distributed.destroy_process_group()


def test_batched_register_data_parallel(world, ref_register):
    _, out = world
    assert out["batched_T"].shape == (8, 4, 4)
    for T in out["batched_T"]:
        np.testing.assert_allclose(T, np.asarray(ref_register.T), rtol=0, atol=1e-9)


def test_sharded_register_matches_local(world, ref_register):
    _, out = world
    np.testing.assert_allclose(out["sharded_T"], np.asarray(ref_register.T), rtol=0, atol=1e-9)
    assert out["sharded_ncorr"] == int(ref_register.num_correspondences)
    np.testing.assert_allclose(out["sharded_error"], float(ref_register.error), rtol=1e-9)


def test_sharded_pose_graph_matches_local(world):
    inp, out = world
    _, ref = _both_graphs(inp["graph_plain"])
    want, chi2 = ref_gg.solve_pose_graph(ref, gn_iters=6)
    np.testing.assert_allclose(out["pcg_p"], np.asarray(want.p), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["pcg_chi2"], float(chi2), rtol=1e-6)


def test_sharded_schur_matches_single_device(world):
    inp, out = world
    _, ref = _both_graphs(inp["graph"])
    want, chi2 = ref_bs.solve_pose_graph_schur(ref, num_blocks=8, gn_iters=6)
    np.testing.assert_allclose(out["schur_p"], np.asarray(want.p), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["schur_chi2"], float(chi2), rtol=1e-6)
    # the drifted start moved
    assert np.abs(out["schur_p"] - inp["graph"]["p"]).max() > 0.05
    # K % S and S % ranks must both divide, as the reference raises
    for msg in out["schur_refused"]:
        assert msg is not None and "divisible" in msg


def test_batched_replay_odometry_sharded(world):
    inp, out = world
    r = inp["replay"]
    single, kf, conv = jax.jit(lambda a, b, c, d: ref_replay_device.replay_odometry(
        a, b, c, d, RefOdometryConfig(use_ego_vel=True), RefRegConfig(method="FAST_GICP",
                                                                      transformation_epsilon=5e-4)))(
        *(jnp.asarray(r[k]) for k in ("xyz", "mask", "ego", "times")))
    assert out["replay_poses"].shape == (WORLD, 5, 4, 4)
    for s in range(WORLD):
        np.testing.assert_allclose(out["replay_poses"][s], np.asarray(single), rtol=0, atol=1e-9)
        np.testing.assert_array_equal(out["replay_kf"][s], np.asarray(kf))
        np.testing.assert_array_equal(out["replay_conv"][s], np.asarray(conv))


def test_batched_window_solve_data_parallel(world):
    """Four windows (two problems, twice) over the data axis: each as the
    JAX package's solve_window solves it (tests/test_torch_backend.py's
    tolerances: 1e-8 in the state, chi2 within 1e-7, the same iterations)."""
    _, out = world
    probs, _ = _windows()
    cfg = dataclasses.replace(RefBackendConfig(), max_solver_iterations=12)
    solve = jax.jit(lambda x, f: ref_win.solve_window(x, f, cfg, BIAS_INFO))
    for i, prob in enumerate(probs):
        xw, chi2_w, it_w = solve(*prob)
        for b in range(i, WORLD, 2):
            assert out["window_iters"][b] == int(it_w)
            for name in ("R", "p", "v", "bg", "ba"):
                np.testing.assert_allclose(out["window_x"][name][b], np.asarray(getattr(xw, name)), rtol=0,
                                           atol=1e-8)
            np.testing.assert_allclose(out["window_chi2"][b], float(chi2_w), rtol=1e-7)


def test_meshed_fleet_equals_unmeshed_bitwise(world):
    _, out = world
    meshed, plain = out["fleet_meshed"], out["fleet_plain"]
    assert set(meshed) == set(plain) and plain["pose"].shape[:2] == (2, 3)
    for k in plain:
        assert meshed[k].dtype == plain[k].dtype, k
        np.testing.assert_array_equal(meshed[k], plain[k], err_msg=k)
    # the two sequences differ (their own seeds and clouds)
    assert not np.array_equal(plain["pose"][0], plain["pose"][1])
