"""The port's CUDA kernels (K1, K2, K3 and the window solve) on the card,
against their plain twins, and the paths that launch them.

Also the asynchronous loop worker beside the frame path: a graph capture
that meets a worker job, the worker's launch counts, and the scan-to-map
registration's graph pair.

Needs an NVIDIA GPU with nvcc; everywhere else every test skips. Run on the
card, without the JAX test harness:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import rivslam_tpu_torch
from rivslam_tpu_torch.core import cuda_graph, prng
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp
from rivslam_tpu_torch.io import synthetic
from rivslam_tpu_torch import pipeline, presets
from rivslam_tpu_torch.io import datasets
from rivslam_tpu_torch.ops import nn_argmin, nn_corr, nn_gather
from torch_window_problem import BIAS_INFO, WINDOW_TOL, twin_limits

pytestmark = pytest.mark.cuda

# d2 from the same separately rounded operations in both: equal up to the
# relative bound; features of a winner are copied, ties are means of a few
D2_RTOL, D2_ATOL, G_ATOL = 1e-4, 1e-6, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    nn_gather.build()
    nn_corr.build()
    nn_argmin.build()
    return torch.device("cuda")


def _inputs(dev, B, N, M, F=9, seed=0, keep=0.85):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (
        t((rng.normal(size=(B, N, 3)) * 10).astype(np.float32)),
        t((rng.normal(size=(B, M, 3)) * 10).astype(np.float32)),
        t(rng.uniform(size=(B, M)) < keep),
        t(rng.normal(size=(B, F, M)).astype(np.float32)),
    )


def _assert_k1_matches_plain(args):
    d2, g = nn_gather.fused_gather(*args)
    pd2, pg = nn_gather.fused_gather_plain(*args)
    torch.cuda.synchronize()
    assert torch.all((d2 - pd2).abs() <= D2_RTOL * pd2.abs() + D2_ATOL)
    assert (g - pg).abs().max().item() <= G_ATOL
    return d2, g


@pytest.mark.parametrize(
    "B,N,M,F",
    [(256, 1024, 1024, 9), (3, 1000, 1500, 9), (2, 97, 513, 5), (1, 1, 1, 1)],
    ids=["main-path", "ragged", "small", "single"],
)
def test_k1_matches_plain_twin(dev, B, N, M, F):
    _assert_k1_matches_plain(_inputs(dev, B, N, M, F))


def test_k1_masked_targets(dev):
    q, r, m, f = _inputs(dev, 3, 300, 700)
    m[0] = False
    d2, g = _assert_k1_matches_plain((q, r, m, f))
    assert torch.all(d2[0] >= 1e30) and torch.all(g[0] == 0)


def test_k1_exact_ties_are_averaged(dev):
    q, r, m, f = _inputs(dev, 2, 300, 1536, keep=1.1)
    r[:, 1024:1280] = r[:, :256]  # duplicates across both tile sizes
    q[:, :256] = r[:, :256]
    d2, g = _assert_k1_matches_plain((q, r, m, f))
    want = (f[:, :, :256] + f[:, :, 1024:1280]) / 2
    assert (g[:, :, :256] - want).abs().max().item() <= G_ATOL


def test_k1_counts_launches_and_rejects_what_it_cannot_take(dev):
    q, r, m, f = _inputs(dev, 2, 64, 128)
    before = nn_gather.fused_gather.launches
    nn_gather.fused_gather(q, r, m, f)
    nn_gather.fused_gather_plain(q, r, m, f)
    assert nn_gather.fused_gather.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        nn_gather.fused_gather(q.double(), r, m, f)
    with pytest.raises(ValueError, match="contiguous"):
        nn_gather.fused_gather(q, r, m, f.transpose(1, 2).contiguous().transpose(1, 2))
    assert nn_gather.fused_gather.launches == before + 1


# ---- K1: both block shapes, ties resolved by a warp in index order -----------


def _k1_contract(q, r, m, f):
    """K1's contract in numpy float32: the twin's distance, operation by
    operation (each rounded on its own), and the tie mean summed in ascending
    index order, then divided. Returns (d2, g, tie counts)."""
    q, r, m, f = (a.cpu().numpy() for a in (q, r, m, f))
    B, N, M, F = q.shape[0], q.shape[1], r.shape[1], f.shape[1]
    d2 = np.full((B, N), np.float32(1e30), np.float32)
    g = np.zeros((B, F, N), np.float32)
    cnt = np.zeros((B, N), np.int64)
    for b in range(B):
        qx, qy, qz = (q[b, :, k, None] for k in range(3))
        rx, ry, rz = (r[b, None, :, k] for k in range(3))
        qn = qx * qx + qy * qy + qz * qz
        rn = rx * rx + ry * ry + rz * rz
        d = (qn + rn) - np.float32(2.0) * (qx * rx + qy * ry + qz * rz)
        d = np.where(m[b][None], d, np.float32(np.inf))
        best = d.min(axis=1)
        for i in np.nonzero(best < np.float32(5e29))[0]:
            js = np.nonzero(d[i] == best[i])[0]
            acc = np.zeros(F, np.float32)
            for j in js:  # ascending index order
                acc = acc + f[b, :, j]
            d2[b, i], g[b, :, i], cnt[b, i] = best[i], acc / np.float32(len(js)), len(js)
    return d2, g, cnt


def _tie_sum_tolerance(q, r, m, f):
    """[B, F, N]: how far K1's features may lie from the twin's: zero for
    one winner or a tie of two; for a tie of n >= 3, n - 1 ulps of the sum
    of the tied features' magnitudes (each order rounds n - 1 additions by
    up to half an ulp), over n, plus an ulp of the mean."""
    _, abs_sum, cnt = nn_gather._plain_scan(q, r, m, f.abs())
    _, g_sum, _ = nn_gather._plain_scan(q, r, m, f)
    n = torch.clamp_min(cnt, 1.0)[:, None]

    def ulp(x):
        return torch.nextafter(x, torch.full_like(x, torch.inf)) - x

    tol = (n - 1.0) * ulp(abs_sum) / n + ulp((g_sum / n).abs())
    return torch.where((cnt >= 3)[:, None], tol, 0.0)


def _assert_k1_contract(args, variant):
    """The block shape equals the contract bitwise (d2 and features), and
    the twin bitwise on d2 and on one- and two-way ties. The twin sums a
    tile's ties in its equality bmm's order, which the library chooses, so
    ties of n >= 3 are held to it within _tie_sum_tolerance."""
    d2, g = nn_gather._launch(*args, variant)
    pd2, pg = nn_gather.fused_gather_plain(*args)
    tol = _tie_sum_tolerance(*args)
    torch.cuda.synchronize()
    cd2, cg, cnt = _k1_contract(*args)
    d2, g, pd2, pg, tol = (a.cpu().numpy() for a in (d2, g, pd2, pg, tol))
    np.testing.assert_array_equal(d2, cd2)
    np.testing.assert_array_equal(g, cg)
    np.testing.assert_array_equal(d2, pd2)
    few = np.broadcast_to((cnt <= 2)[:, None, :], g.shape)
    np.testing.assert_array_equal(g[few], pg[few])
    assert np.all(np.abs(g - pg) <= tol)
    return d2, g, cnt


VARIANTS = (nn_gather.BATCH_VARIANT, nn_gather.SINGLE_VARIANT)
VARIANT_IDS = [v.name for v in VARIANTS]


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_k1_variant_ties_of_three_or_more_in_index_order(dev, variant):
    q, r, m, f = _inputs(dev, 2, 200, 1100, keep=1.1)
    r[:, 300:340] = r[:, :40]  # targets 0..39 appear 4 times, 40..79 3 times
    r[:, 600:640] = r[:, :40]
    r[:, 500:540] = r[:, 40:80]
    r[:, 900:980] = r[:, :80]
    q[:, :80] = r[:, :80]
    d2, g, cnt = _assert_k1_contract((q, r, m, f), variant)
    assert (cnt[:, :40] == 4).all() and (cnt[:, 40:80] == 3).all()


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_k1_variant_ties_across_the_tile_edge(dev, variant):
    q, r, m, f = _inputs(dev, 2, 300, 1300, keep=1.1)
    r[:, 512:612] = r[:, 412:512]  # each pair straddles the 512-target tile edge
    q[:, :100] = r[:, 412:512]
    m[1, 430] = False  # a masked duplicate never ties
    d2, g, cnt = _assert_k1_contract((q, r, m, f), variant)
    assert (cnt[0, :100] == 2).all() and cnt[1, 18] == 1


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_k1_variant_many_tied_queries_in_one_warp(dev, variant):
    q, r, m, f = _inputs(dev, 3, 256, 1024, F=9, keep=1.1)
    r[:, 700:764] = r[:, 0:64]
    q[:, 64:128] = r[:, 0:64]  # two full warps of tied queries
    q[:, 200:232] = r[:, 5, None]  # one warp all on the same tied target
    _, _, cnt = _assert_k1_contract((q, r, m, f), variant)
    assert (cnt[:, 64:128] == 2).all() and (cnt[:, 200:232] == 2).all()


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_k1_variant_fully_masked_and_wide_features(dev, variant):
    q, r, m, f = _inputs(dev, 3, 130, 600, F=40)
    m[0] = False
    r[2, 100:110] = r[2, :10]
    q[2, :10] = r[2, :10]
    d2, g, _ = _assert_k1_contract((q, r, m, f), variant)
    assert (d2[0] >= 1e30).all() and (g[0] == 0).all()


def test_k1_variants_agree_on_the_main_path_inputs(dev):
    *data, _ = synthetic.load_pairs(16, 1024, device=dev)
    tgt = apdgicp.prepare(data[2], data[3], RegistrationConfig(), device=dev)
    from rivslam_tpu_torch.core.pointcloud import SENTINEL
    ref = torch.where(tgt.mask[..., None], tgt.xyz, SENTINEL).contiguous()
    c = tgt.cov
    f = torch.stack(list(tgt.xyz.unbind(-1)) + [c[..., 0, 0], c[..., 0, 1], c[..., 0, 2],
                                               c[..., 1, 1], c[..., 1, 2], c[..., 2, 2]], 1)
    args = (data[0].contiguous(), ref, tgt.mask.contiguous(), f.contiguous())
    first = nn_gather.fused_gather(*args)
    for v in VARIANTS:
        d2, g = nn_gather._launch(*args, v)
        assert torch.equal(d2, first[0]) and torch.equal(g, first[1]), v.name
    _assert_k1_contract(args, nn_gather.variant_for(16, 1024, dev))
    assert nn_gather.variant_for(256, 1024, dev) == nn_gather.BATCH_VARIANT
    assert nn_gather.variant_for(1, 1024, dev) == nn_gather.SINGLE_VARIANT


def test_main_path_runs_through_k1(dev):
    *data, rel = synthetic.load_pairs(8, 1024, device=dev)
    guess = torch.eye(4, device=dev).expand(8, 4, 4)
    cfg = RegistrationConfig(use_pallas_correspondence=True)
    before = nn_gather.fused_gather.launches
    src = apdgicp.prepare(data[0], data[1], cfg, device=dev)
    tgt = apdgicp.prepare(data[2], data[3], cfg, device=dev)
    res = apdgicp.register_dispatch(src, tgt, guess, cfg, device=dev)
    launches = nn_gather.fused_gather.launches - before
    # one launch per outer iteration of the longest problem, plus the final one
    assert launches == int(res.iterations.max()) + 1
    assert bool(res.converged.all())
    terr = np.linalg.norm(res.T.cpu().numpy()[:, :3, 3] - rel[:, :3, 3], axis=1)
    assert np.median(terr) < 0.1
    off = apdgicp.register_dispatch(
        src, tgt, guess, dataclasses.replace(cfg, use_pallas_correspondence=False), device=dev
    )
    assert nn_gather.fused_gather.launches - before == launches
    assert (off.T - res.T).abs().max().item() < 1e-3


def test_entry_on_the_card_matches_the_cpu(dev):
    fn, args = rivslam_tpu_torch.entry(device=dev)
    res = fn(*args)
    fn_cpu, args_cpu = rivslam_tpu_torch.entry(device="cpu")
    ref = fn_cpu(*args_cpu)
    assert (res.T.cpu() - ref.T).abs().max().item() < 1e-3
    assert int(res.num_correspondences) == int(ref.num_correspondences)


# ---- K3: d2 from the same separately rounded operations, so bitwise equal --


def _assert_k3_matches_plain(q, r, m):
    idx, d2 = nn_argmin.nearest_neighbor(q, r, m)
    pidx, pd2 = nn_argmin.nearest_neighbor_plain(q, r, m)
    torch.cuda.synchronize()
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    return idx, d2


@pytest.mark.parametrize(
    "B,N,M",
    [(1, 1024, 1024), (256, 1024, 1024), (3, 1000, 1500), (2, 97, 513), (1, 1, 1)],
    ids=["engine", "batched", "ragged", "small", "single"],
)
def test_k3_matches_plain_twin(dev, B, N, M):
    _assert_k3_matches_plain(*_inputs(dev, B, N, M)[:3])


def test_k3_masked_refs(dev):
    q, r, m, _ = _inputs(dev, 3, 300, 700)
    m[0] = False
    idx, d2 = _assert_k3_matches_plain(q, r, m)
    assert torch.all(d2[0] == 1e30) and torch.all(idx[0] == 0)
    assert bool(m[1][idx[1].long()].all()) and bool(m[2][idx[2].long()].all())


def test_k3_first_index_wins_exact_ties(dev):
    q, r, m, _ = _inputs(dev, 2, 300, 1100, keep=1.1)
    r[:, 512:768] = r[:, :256]  # duplicates across the 512-ref tile edge
    r[:, 300:350] = r[:, :50]  # and inside the first tile
    q[:, :256] = r[:, :256]
    idx, _ = _assert_k3_matches_plain(q, r, m)
    assert torch.equal(idx[:, :256], torch.arange(256, device=dev, dtype=torch.int32).expand(2, 256))


def test_k3_counts_launches_and_rejects_what_it_cannot_take(dev):
    q, r, m, _ = _inputs(dev, 2, 64, 128)
    before = nn_argmin.nearest_neighbor.launches
    nn_argmin.nearest_neighbor(q, r, m)
    nn_argmin.nearest_neighbor_plain(q, r, m)
    assert nn_argmin.nearest_neighbor.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        nn_argmin.nearest_neighbor(q.double(), r, m)
    with pytest.raises(ValueError, match="contiguous"):
        nn_argmin.nearest_neighbor(q, r.transpose(1, 2).contiguous().transpose(1, 2), m)
    assert nn_argmin.nearest_neighbor.launches == before + 1


def test_engine_runs_through_k1_and_k3(dev):
    """A few frames of the cp course at full width: K3 once per frame (the
    backend's fitness) and once per keyframe after the first (the keyframe
    graph's odometry-edge information), K1 in every registration LM step,
    finite poses."""
    seq, _ = synthetic.simulate_sequence(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=4,
                                         capacity=1024, world_points=20000, extent=30.0)
    cfg = presets.get("cp")
    cfg = dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, enable=False),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )
    k1, k3 = nn_gather.fused_gather.launches, nn_argmin.nearest_neighbor.launches
    outs = datasets.replay(pipeline.Engine(cfg, device=dev), seq, 1024, 64)
    n_kf = sum(o["is_keyframe"] for o in outs)
    assert nn_argmin.nearest_neighbor.launches - k3 == 4 + n_kf - 1
    assert nn_gather.fused_gather.launches - k1 >= 3
    assert all(np.isfinite(o["pose"]).all() for o in outs)


# ---- K2 ------------------------------------------------------------------------


def _k2_inputs(dev, B, N, M, F=12, seed=0, keep=0.85):
    q, r, m, _ = _inputs(dev, B, N, M, seed=seed, keep=keep)
    f = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=(B, M, F)).astype(np.float32), device=dev)
    return q, r, m, f


def _assert_k2_matches_plain(q, r, m, f):
    """idx and the gathered rows equal, d2 bitwise."""
    idx, d2, g = nn_corr.fused_correspondence(q, r, m, f)
    pidx, pd2, pg = nn_corr.fused_correspondence_plain(q, r, m, f)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx) and torch.equal(d2, pd2) and torch.equal(g, pg)
    return idx, d2, g


@pytest.mark.parametrize(
    "B,N,M,F",
    [(1, 1024, 1024, 12), (256, 1024, 1024, 12), (3, 1000, 1500, 12), (2, 97, 513, 1),
     (2, 300, 700, 128), (1, 1, 1, 1)],
    ids=["engine", "batched", "ragged", "F1", "F128", "single"],
)
def test_k2_matches_plain_twin(dev, B, N, M, F):
    _assert_k2_matches_plain(*_k2_inputs(dev, B, N, M, F))


def test_k2_masked_refs(dev):
    q, r, m, f = _k2_inputs(dev, 3, 300, 700)
    m[0] = False
    idx, d2, g = _assert_k2_matches_plain(q, r, m, f)
    assert torch.all(d2[0] == 1e30) and torch.all(idx[0] == 0) and torch.all(g[0] == 0)
    assert bool(m[1][idx[1].long()].all())


def test_k2_first_index_wins_exact_ties(dev):
    q, r, m, f = _k2_inputs(dev, 2, 300, 1100, keep=1.1)
    r[:, 512:768] = r[:, :256]
    r[:, 300:350] = r[:, :50]
    q[:, :256] = r[:, :256]
    idx, _, g = _assert_k2_matches_plain(q, r, m, f)
    assert torch.equal(idx[:, :256], torch.arange(256, device=dev, dtype=torch.int32).expand(2, 256))
    assert torch.equal(g[:, :256], f[:, :256])


def test_k2_counts_launches_and_rejects_what_it_cannot_take(dev):
    q, r, m, f = _k2_inputs(dev, 2, 64, 128)
    before = nn_corr.fused_correspondence.launches
    nn_corr.fused_correspondence(q, r, m, f)
    nn_corr.fused_correspondence_plain(q, r, m, f)
    assert nn_corr.fused_correspondence.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        nn_corr.fused_correspondence(q, r, m, f.double())
    with pytest.raises(ValueError, match="contiguous"):
        nn_corr.fused_correspondence(q, r, m, f.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="features"):
        nn_corr.fused_correspondence(q, r, m, torch.zeros(2, 128, 129, device=dev))
    assert nn_corr.fused_correspondence.launches == before + 1


@pytest.mark.parametrize("method", ["FAST_APDGICP", "GICP", "ICP"])
def test_exact_path_runs_through_k2_and_matches_the_cpu(dev, method):
    _, args = rivslam_tpu_torch.entry(device=dev)
    cfg = RegistrationConfig(method=method, use_fast_path=False)
    before = nn_corr.fused_correspondence.launches
    res = apdgicp.prepare_and_register(*args, cfg, device=dev)
    # one correspondence step per outer iteration, and the final one
    assert nn_corr.fused_correspondence.launches - before == int(res.iterations) + 1
    cpu = apdgicp.prepare_and_register(*[a.cpu() for a in args], cfg, device="cpu")
    assert (res.T.cpu() - cpu.T).abs().max().item() <= 1e-3
    assert int(res.num_correspondences) == int(cpu.num_correspondences)


def test_engine_with_loop_closure_and_exact_path(dev):
    """A few frames of the cp course at full width with the preset as
    shipped (loop closure on) and through the exact registration: K2 in
    every exact registration step, finite poses, the graph filled."""
    seq, _ = synthetic.simulate_sequence(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=4,
                                         capacity=1024, world_points=20000, extent=30.0)
    cfg = presets.get("cp")
    cfg = dataclasses.replace(cfg, registration=dataclasses.replace(cfg.registration, use_fast_path=False))
    k2 = nn_corr.fused_correspondence.launches
    eng = pipeline.Engine(cfg, device=dev)
    outs = datasets.replay(eng, seq, 1024, 64)
    assert nn_corr.fused_correspondence.launches - k2 >= 3
    assert all(np.isfinite(o["pose"]).all() for o in outs)
    assert eng.state.kf_count == sum(o["is_keyframe"] for o in outs)
    ts, poses = eng.trajectory()
    assert poses.shape == (4, 4, 4) and np.isfinite(poses).all()


# ---- the backend: its CUDA graphs and the window kernel -----------------------------


def _backend_frames(n_frames=5, cap=192, imu_cap=48):
    """Frames along the simulator's circle (numpy, the port's simulator):
    noisy odometry poses, a scan, analytic IMU samples, ego velocity, floor."""
    from rivslam_tpu_torch.core import lie

    rng = np.random.default_rng(11)
    world = synthetic.make_world(rng, n_points=4000)
    times, poses, vels = synthetic.circular_trajectory(n_frames, dt=0.25, height=2.0)
    frames = []
    for i in range(n_frames):
        cl = synthetic.observe(world, poses[i], rng, capacity=cap, noise=0.01, device="cpu")
        rel = np.linalg.inv(poses[0]) @ poses[i]
        odom = rel @ lie.se3_exp(torch.as_tensor(rng.normal(size=6) * 0.01)).numpy()
        dts, acc, gyr, m = np.zeros(imu_cap), np.zeros((imu_cap, 3)), np.zeros((imu_cap, 3)), np.zeros(imu_cap, bool)
        if i > 0:
            d, a, g = synthetic.circular_imu_samples(times[i - 1], times[i], rate=100.0)
            k = len(d)
            dts[:k], acc[:k], gyr[:k], m[:k] = d, a, g, True
            m[3] = False  # a gap in the buffer
        frames.append(dict(
            stamp=np.asarray(times[i]), odom_R=odom[:3, :3], odom_p=odom[:3, 3],
            xyz=np.asarray(cl.xyz), mask=np.asarray(cl.mask), ego_vel=poses[i][:3, :3].T @ vels[i],
            ego_vel_cov=np.full(3, 1e-3), imu_dts=dts, imu_acc=acc, imu_gyr=gyr, imu_mask=m,
            floor=np.array([0.0, 0.0, 1.0, 2.0]) + rng.normal(size=4) * 1e-3,
            floor_valid=np.asarray(i % 3 != 1),
        ))
    return frames


@pytest.mark.parametrize("optimizer,use_schur", [("LM", False), ("LM", True), ("GN", False)],
                         ids=["LM-dense", "LM-schur", "GN-dense"])
def test_graphed_backend_equals_its_eager_run(dev, optimizer, use_schur):
    """Several frames of changing factors through backend_step with the
    Engine's backend pieces, so nothing stale is carried from frame to
    frame: the preintegration's CUDA graph gives bitwise what the eager
    preintegration gives on the card, and on each window that backend_step
    rolls and fills, the window kernel (``FusedSolver``, one launch a
    frame) gives what its plain twin gives on the CPU, within the limits
    that the twin's own spread on that window sets (``twin_limits``), with
    the same iterations and tries."""
    from rivslam_tpu_torch.backend import slam
    from rivslam_tpu_torch.core import config, cuda_graph
    from rivslam_tpu_torch.factors import preintegration as pre
    from rivslam_tpu_torch.solver import window

    bk = dataclasses.replace(config.BackendConfig(), optimizer=optimizer, use_schur=use_schur)
    imu = config.ImuConfig()
    graphs = slam.BackendGraphs(bk, imu, torch.float32, dev)
    fused = graphs.solve
    bias_info, iters = slam.bias_information(imu), []

    def solve(x0, f):
        got = fused(x0, f)
        x_cpu, f_cpu = _on(x0, "cpu"), _on(f, "cpu")
        tol = twin_limits(x_cpu, f_cpu, bk, bias_info, use_schur)
        xk, chi2_k, it_k, tries_k = _kernel_against_twin(dev, x_cpu, f_cpu, bk, use_schur, tol, bias_info)
        assert (got[2], got[3]) == (it_k, tries_k) and float(got[1]) == chi2_k
        for a, b in zip(got[0].astuple(), xk.astuple()):
            assert torch.equal(a.cpu(), b)  # the Engine's launch is the one held to the twin
        iters.append(it_k)
        return got

    graphs.solve = solve
    st = slam.init_state(bk, imu, 192, torch.float32, dev)
    launches = window.solve_batched.launches
    frames = _backend_frames()
    for fr in frames:
        frame = slam.BackendFrame(**{
            k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool else torch.float32, device=dev)
            for k, v in fr.items()})
        prev = st
        st, out = slam.backend_step(st, frame, bk, imu, graphs)
        assert out.iterations == iters[-1]
        with cuda_graph.cusolver():
            want = pre.preintegrate(frame.imu_dts, frame.imu_acc, frame.imu_gyr, frame.imu_mask,
                                    prev.nav.bg[-1], prev.nav.ba[-1], imu.gyr_noise, imu.acc_noise)
        for a, b in zip(st.preint.astuple(), want.astuple()):
            assert torch.equal(a[-1], b)  # the frame's graph replay, bitwise the eager function
    assert fused.replays == len(frames) and graphs.preintegrate.replays == len(frames) and max(iters) >= 2
    assert window.solve_batched.launches - launches == 2 * len(frames)  # the Engine's and the check's


ROBUST = ("odometry_edge_robust_kernel", "scan_match_prior_robust_kernel", "integ_edge_robust_kernel",
          "floor_edge_robust_kernel")


def _on(obj, dev):
    return type(obj)(**{f.name: _on(getattr(obj, f.name), dev) if dataclasses.is_dataclass(getattr(obj, f.name))
                        else getattr(obj, f.name).to(dev) for f in dataclasses.fields(obj)})


def _window_cfg(optimizer="LM", kernels="shipped", **kw):
    from rivslam_tpu_torch.core import config

    bk = dataclasses.replace(config.BackendConfig(), optimizer=optimizer, **kw)
    if kernels != "shipped":
        bk = dataclasses.replace(bk, **{k: kernels for k in ROBUST})
    return bk


def _kernel_against_twin(dev, x0, f, bk, use_schur=False, tol=WINDOW_TOL["shipped"], bias_info=BIAS_INFO):
    """One kernel launch on the card against the twin on the CPU; returns
    the kernel's (state, chi2, iterations, tries)."""
    from rivslam_tpu_torch.solver import window

    xt, chi2_t, it_t, tries_t = window.solve_window(x0, f, bk, bias_info, use_schur)
    xk, chi2_k, counts = window.solve_batched(window._lead1(_on(x0, dev)), window._lead1(_on(f, dev)), bk, bias_info)
    torch.cuda.synchronize()
    xk = window.WindowState(*(t[0].cpu() for t in xk.astuple()))
    it_k, tries_k = counts[0].tolist()
    assert (it_k, tries_k) == (it_t, tries_t)
    for a, b in zip(xk.astuple(), xt.astuple()):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol[0])
    chi2_k = float(chi2_k[0])
    assert abs(chi2_k - float(chi2_t)) <= tol[1] * max(abs(float(chi2_t)), 1e-30)
    return xk, chi2_k, it_k, tries_k


@pytest.mark.parametrize("use_schur", [False, True], ids=["dense", "schur"])
@pytest.mark.parametrize("optimizer,kernels", [("LM", "NONE"), ("LM", "shipped"), ("LM", "Cauchy"),
                                               ("GN", "NONE"), ("GN", "shipped")])
def test_window_kernel_matches_its_twin(dev, optimizer, kernels, use_schur):
    from torch_window_problem import make_window

    for seed in (2, 5):
        x0, f = make_window(seed=seed, dtype=torch.float32)
        _kernel_against_twin(dev, x0, f, _window_cfg(optimizer, kernels), use_schur, WINDOW_TOL[kernels])


@pytest.mark.parametrize("case", ["masked", "no_ground", "converged", "first_frame"])
def test_window_kernel_on_partial_windows(dev, case):
    """A window still filling up (leading slots masked), ground edges
    absent, a window whose first iteration is already done (started at
    the twin's solution), and the Engine's first frame (one valid slot: H
    = 0, lambda = 0, a damped system that is not positive definite, every
    try rejected rather than NaN in the state)."""
    from rivslam_tpu_torch.solver import window
    from torch_window_problem import BIAS_INFO, make_window

    x0, f = make_window(dtype=torch.float32)
    bk = _window_cfg()
    if case == "masked":
        f = dataclasses.replace(f, frame_mask=torch.tensor([False, False, True, True, True, True]))
    elif case == "no_ground":
        f = dataclasses.replace(f, plane_valid=torch.tensor([True, False, True, False, True, True]))
    elif case == "converged":
        x0 = window.solve_window(x0, f, dataclasses.replace(bk, max_solver_iterations=40), BIAS_INFO)[0]
    else:
        f = dataclasses.replace(f, frame_mask=torch.tensor([False] * 5 + [True]))
    x, chi2, it, tries = _kernel_against_twin(dev, x0, f, bk)
    if case == "converged":
        assert it == 1
    if case == "first_frame":
        assert (it, tries, chi2) == (1, window.INNER_TRIES, 0.0)
        for a, b in zip(x.astuple(), x0.astuple()):
            assert torch.equal(a, b)


def test_window_kernel_float64_matches_its_twin(dev):
    """In float64 the kernel and the twin part only by rounding."""
    from torch_window_problem import make_window

    for optimizer in ("LM", "GN"):
        x0, f = make_window(dtype=torch.float64)
        _kernel_against_twin(dev, x0, f, _window_cfg(optimizer), tol=(1e-9, 1e-11))


def test_window_kernel_batch_equals_single_launches(dev):
    """B = 3 windows in one launch (a block each) give bitwise what three
    launches of B = 1 give."""
    from rivslam_tpu_torch.solver import window
    from torch_window_problem import BIAS_INFO, make_window

    probs = [make_window(seed=s, dtype=torch.float32, device=dev) for s in (1, 2, 5)]
    probs[1] = (probs[1][0], dataclasses.replace(
        probs[1][1], frame_mask=torch.tensor([False, True, True, True, True, True], device=dev)))
    bk = _window_cfg()

    def stack(objs):
        return type(objs[0])(**{f.name: stack([getattr(o, f.name) for o in objs])
                                if dataclasses.is_dataclass(getattr(objs[0], f.name))
                                else torch.stack([getattr(o, f.name) for o in objs])
                                for f in dataclasses.fields(objs[0])})

    launches = window.solve_batched.launches
    xb, chi2_b, counts_b = window.solve_batched(stack([p[0] for p in probs]), stack([p[1] for p in probs]), bk, BIAS_INFO)
    assert window.solve_batched.launches - launches == 1
    for b, (x0, f) in enumerate(probs):
        x1, chi2_1, counts_1 = window.solve_batched(window._lead1(x0), window._lead1(f), bk, BIAS_INFO)
        assert torch.equal(counts_b[b], counts_1[0]) and torch.equal(chi2_b[b], chi2_1[0])
        for a, c in zip(xb.astuple(), x1.astuple()):
            assert torch.equal(a[b], c[0])


def test_window_kernel_counts_launches_and_refuses_what_it_cannot_take(dev):
    from rivslam_tpu_torch.solver import window
    from torch_window_problem import BIAS_INFO, make_window

    assert window.max_window(torch.float32) == 25 and window.max_window(torch.float64) == 12
    x0, f = make_window(dtype=torch.float32, device=dev)
    solver = window.FusedSolver(_window_cfg(), BIAS_INFO, torch.float32)
    launches = window.solve_batched.launches
    _, _, it, _ = solver(x0, f)
    assert solver.replays == 1 and window.solve_batched.launches - launches == 1 and it >= 2
    W = window.max_window(torch.float32) + 1
    xw, fw = make_window(windows=W, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match=f"window of {W} slots"):
        solver(xw, fw)
    half = window.WindowState(*(t.half() for t in x0.astuple()))
    with pytest.raises(ValueError, match="float32 or float64"):
        solver(half, f)
    assert solver.replays == 1 and window.solve_batched.launches - launches == 1
    xl, fl = make_window(windows=window.max_window(torch.float32), dtype=torch.float32)
    _kernel_against_twin(dev, xl, fl, _window_cfg())  # the largest window the kernel takes


def test_graphed_preintegration_equals_eager(dev):
    """Frames of changing IMU buffers replay bitwise what the eager function
    gives; a buffer of another length gets a graph of its own."""
    from rivslam_tpu_torch.factors import preintegration as pre

    g = cuda_graph.GraphCache(lambda K: pre.capture_graph(K, 1e-3, 1e-2, torch.float32, dev))
    rng = np.random.default_rng(3)
    for frame, K in enumerate((40, 40, 40, 40, 20, 20, 40)):
        mask = rng.uniform(size=K) < 0.8
        mask[K - 10 + frame:] = False
        args = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
            rng.uniform(0.004, 0.006, K), rng.normal(size=(K, 3)) * 0.3 + [0, 0, 9.8],
            rng.normal(size=(K, 3)) * 0.2)]
        args += [torch.as_tensor(mask, device=dev)]
        args += [torch.as_tensor(rng.normal(size=3) * 0.01, dtype=torch.float32, device=dev) for _ in range(2)]
        graph = g.get(K, K)
        graph.load(*args)
        got = pre.Preintegration(*(t.clone() for t in graph.replay()))
        want = pre.preintegrate(*args, 1e-3, 1e-2)
        for a, b in zip(got.astuple(), want.astuple()):
            assert torch.equal(a, b)
    assert sorted(g.graphs) == [20, 40] and g.replays == 7


def test_engine_replays_graphs_and_counts_its_kernels(dev):
    """The Engine on the card runs its backend through the graphs and the
    window kernel, one launch a frame; the K3 launches stay outside the
    graphs, so their count is exact."""
    seq, _ = synthetic.simulate_sequence(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=3,
                                         capacity=1024, world_points=20000, extent=30.0)
    cfg = presets.get("cp")
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enable=False))
    eng = pipeline.Engine(cfg, device=dev)
    from rivslam_tpu_torch.solver import window

    k3 = nn_argmin.nearest_neighbor.launches
    solves = window.solve_batched.launches
    outs = datasets.replay(eng, seq, 1024, 64)
    assert eng.graphs.preintegrate.replays == 3
    assert eng.graphs.solve.replays == 3 and window.solve_batched.launches - solves == 3
    n_kf = sum(o["is_keyframe"] for o in outs)
    assert nn_argmin.nearest_neighbor.launches - k3 == 3 + n_kf - 1


def test_a_failed_capture_raises(dev):
    """A host read inside a captured function fails the capture, and the
    failure raises: there is no eager fallback. The card works after it,
    torch's CUDA generator included."""
    x = torch.ones(4, device=dev)
    with pytest.raises(RuntimeError, match="CUDA graph capture of host-read failed"):
        cuda_graph.Graphed("host-read", lambda t: (t * float(t.sum().item()),), [x])
    torch.cuda.synchronize()
    y = torch.ones(4, device=dev) * 2  # the device still works after the failed capture
    assert float(y.sum()) == 8.0
    _card_works_after_a_failed_capture(dev)


def _card_works_after_a_failed_capture(dev):
    """Right after a failed capture, with no capture between: torch's CUDA
    generator draws (a capture that fails before it ends would leave it in
    capture mode, and ``torch.randn`` on the card would raise "Offset
    increment outside graph capture"), and a capture succeeds."""
    assert torch.isfinite(torch.randn(4, device=dev)).all()
    g = cuda_graph.Graphed("after a failed capture", lambda t: (t + 1.0,), [torch.ones(4, device=dev)])
    assert float(g.replay()[0].sum()) == 8.0


# ---- K2 and K3 split across a cluster (every S) -----------------------------------


def _split_inputs(dev, S, F=12, N=1024, M=1024, keep=0.3, seed=21):
    """The engine's shape (B=1, about 30% valid refs) with exact ties on
    either side of every boundary of S slices: the last valid ref of each
    slice copied onto the first of the next, query s on it (the earlier
    index must win), and a masked copy below it (it must never win)."""
    rng = np.random.default_rng(seed + S)
    r = (rng.normal(size=(1, M, 3)) * 10).astype(np.float32)
    m = rng.uniform(size=(1, M)) < keep
    q = (rng.normal(size=(1, N, 3)) * 10).astype(np.float32)
    valid = np.flatnonzero(m[0])
    ties = []
    for s in range(1, S):
        lo, hi = valid[len(valid) * s // S - 1], valid[len(valid) * s // S]
        r[0, hi] = r[0, lo]
        q[0, s] = r[0, lo]
        r[0, np.flatnonzero(~m[0, :lo])[-1]] = r[0, lo]
        ties.append((s, lo))
    f = rng.normal(size=(1, M, F)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(q), t(r), t(m), t(f)), ties


SPLITS = list(range(1, nn_argmin.MAX_SPLIT + 1))


@pytest.mark.parametrize("S", SPLITS)
def test_k3_every_split_equals_the_twin(dev, S):
    (q, r, m, _), ties = _split_inputs(dev, S)
    idx, d2 = nn_argmin._launch(q, r, m, S)
    pidx, pd2 = nn_argmin.nearest_neighbor_plain(q, r, m)
    torch.cuda.synchronize()
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    assert all(int(idx[0, qi]) == lo for qi, lo in ties)


@pytest.mark.parametrize("F", [9, 12, 128])
@pytest.mark.parametrize("S", SPLITS)
def test_k2_every_split_equals_the_twin(dev, S, F):
    (q, r, m, f), ties = _split_inputs(dev, S, F=F)
    idx, d2, g = nn_corr._launch(q, r, m, f, S)
    pidx, pd2, pg = nn_corr.fused_correspondence_plain(q, r, m, f)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx) and torch.equal(d2, pd2) and torch.equal(g, pg)
    assert all(int(idx[0, qi]) == lo and torch.equal(g[0, qi], f[0, lo]) for qi, lo in ties)


@pytest.mark.parametrize("S", SPLITS)
def test_k2_k3_split_fully_masked_and_ragged(dev, S):
    """No valid ref at all (1e30, index 0, zero rows), and N, M that are not
    multiples of the block, the chunk or S."""
    q, r, m, f = _k2_inputs(dev, 1, 1000, 1500, F=12)
    for mask in (torch.zeros_like(m), m):
        got3 = nn_argmin._launch(q, r, mask, S)
        got2 = nn_corr._launch(q, r, mask, f, S)
        want3 = nn_argmin.nearest_neighbor_plain(q, r, mask)
        want2 = nn_corr.fused_correspondence_plain(q, r, mask, f)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got3 + got2, want3 + want2))
        if not mask.any():
            idx, d2, g = got2
            assert torch.all(d2 == 1e30) and torch.all(idx == 0) and torch.all(g == 0)


def test_split_for_splits_only_a_grid_that_leaves_sms_idle(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert nn_argmin.split_for(256, 1024, dev) == 1
    assert 1 < nn_argmin.split_for(1, 1024, dev) <= nn_argmin.MAX_SPLIT
    assert nn_argmin.split_for(1, 1024, dev) * 16 <= max(sms, 16)
    # the public wrappers launch split_for's S: the same bits as the twin
    q, r, m, f = _k2_inputs(dev, 1, 1024, 1024, keep=0.3)
    _assert_k2_matches_plain(q, r, m, f)
    _assert_k3_matches_plain(q, r, m)


# ---- the registration's CUDA graphs ------------------------------------------------


def _registration_frames(dev, cfg, n_frames=5, cap=512):
    """Prepared clouds along the simulator's circle (changing source and
    target every frame) and a perturbed guess per frame."""
    from rivslam_tpu_torch.core import lie

    rng = np.random.default_rng(5)
    world = synthetic.make_world(rng, n_points=4000)
    _, poses, _ = synthetic.circular_trajectory(n_frames + 1, dt=0.25, height=2.0)
    clouds = [synthetic.observe(world, p, rng, capacity=cap, noise=0.01, device=dev) for p in poses]
    prepared = [apdgicp.prepare(c.xyz[None], c.mask[None], cfg, device=dev) for c in clouds]
    frames = []
    for i in range(1, n_frames + 1):
        rel = np.linalg.inv(poses[i - 1]) @ poses[i]
        guess = rel @ lie.se3_exp(torch.as_tensor(rng.normal(size=6) * 0.02)).numpy()
        frames.append((prepared[i], prepared[i - 1],
                       torch.as_tensor(guess[None], dtype=torch.float32, device=dev)))
    return frames


REG_CASES = [
    dict(use_pallas_correspondence=True),
    dict(use_pallas_correspondence=False, optimizer="GN"),
    dict(use_fast_path=False),
    dict(use_fast_path=False, method="GICP", optimizer="GN"),
    dict(method="VGICP"),
    dict(method="NDT_OMP", transformation_epsilon=1e-2),
]


@pytest.mark.parametrize("kw", REG_CASES, ids=["fast-K1-LM", "fast-GN", "exact-K2-LM", "exact-GICP-GN",
                                               "vgicp-LM", "ndt-LM"])
def test_graphed_registration_equals_its_eager_run(dev, kw):
    """Five frames of changing source and target through the registration's
    CUDA graphs give bitwise what the same functions give eagerly on the
    card, with the same K1/K2 launches counted per frame (the graphs credit
    their captured launches at each replay); one capture for the key. The
    voxel methods (VGICP, NDT) are models of the same LM driver and replay
    the same way (no kernel of their own)."""
    cfg = RegistrationConfig(**kw)
    graphs = apdgicp.GraphedRegistration()
    counted = (nn_gather.fused_gather, nn_corr.fused_correspondence)
    for src, tgt, guess in _registration_frames(dev, cfg):
        before = [k.launches for k in counted]
        got = apdgicp.register_dispatch(src, tgt, guess, cfg, device=dev, graphs=graphs)
        torch.cuda.synchronize()
        graphed = [k.launches - b for k, b in zip(counted, before)]
        before = [k.launches for k in counted]
        with cuda_graph.cusolver():
            want = apdgicp.register_dispatch(src, tgt, guess, cfg, device=dev, eager=True)
        torch.cuda.synchronize()
        eager = [k.launches - b for k, b in zip(counted, before)]
        for field in dataclasses.fields(want):
            assert torch.equal(getattr(got, field.name), getattr(want, field.name)), field.name
        assert graphed == eager
        if cfg.use_pallas_correspondence or not cfg.use_fast_path:
            assert sum(eager) == int(want.iterations.max()) + 1
    assert len(graphs.cache.graphs) == 1 and graphs.replays > 5


def test_engine_replays_the_registration_and_counts_k1_through_it(dev):
    """The Engine's odometry replays the registration's graphs (captured on
    its first registration): one host read per outer iteration, and K1's
    count per frame through the replays equals one launch per iteration
    executed plus the final step's."""
    seq, _ = synthetic.simulate_sequence(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=4,
                                         capacity=1024, world_points=20000, extent=30.0)
    cfg = presets.get("cp")
    cfg = dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, enable=False),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )
    eng = pipeline.Engine(cfg, device=dev)
    k1 = nn_gather.fused_gather.launches
    datasets.replay(eng, seq, 1024, 64)
    reg = eng.reg_graphs
    assert len(reg.cache.graphs) == 1
    ((iteration, final),) = reg.cache.graphs.values()
    assert final.replays == 3  # frames 1..3 register; frame 0 starts the odometry
    assert iteration.launches == {nn_gather.fused_gather: 1}
    assert nn_gather.fused_gather.launches - k1 == iteration.replays + final.replays
    assert reg.reads <= iteration.replays


def test_a_failed_registration_capture_raises(dev):
    """A host read inside the registration's iteration fails its capture,
    and the failure raises with the piece's name: there is no eager
    fallback."""
    from rivslam_tpu_torch.frontend import apdgicp_fast

    cfg = RegistrationConfig(use_pallas_correspondence=True)
    src, tgt, guess = _registration_frames(dev, cfg, n_frames=1)[0]

    def host_reading_model(*args):
        linearize_at, error_at, final_at = apdgicp_fast.fast_model(*args)

        def linearize(T):
            H, b, y0, ctx = linearize_at(T)
            return H * float(y0.sum()), b, y0, ctx

        return linearize, error_at, final_at

    graphs = apdgicp.GraphedRegistration()
    with pytest.raises(RuntimeError, match="CUDA graph capture of registration iteration host_reading_model"):
        apdgicp.run_registration(host_reading_model, apdgicp_fast.fast_problem(src, tgt),
                                 guess, cfg, graphs)
    torch.cuda.synchronize()
    assert float(torch.ones(4, device=dev).sum()) == 4.0
    _card_works_after_a_failed_capture(dev)


# ---- the module's registration store: graphs for callers that hand none ----------

STORE_CASES = {
    "fast-K1": dict(use_pallas_correspondence=True),
    "fast-gicp-K1": dict(method="FAST_GICP", use_pallas_correspondence=True),
    "exact-K2": dict(use_fast_path=False),
}


@pytest.fixture(scope="module")
def scan_pairs():
    """256 consecutive frame pairs of the bench course at capacity 1024
    (the scan-match cell's shape), on the host."""
    return synthetic.load_pairs(256, 1024, device="cpu")[:4]


@pytest.fixture
def fresh_store(monkeypatch):
    """The module's store emptied for the test (and put back after)."""
    monkeypatch.setattr(apdgicp, "_graphs", None)


def _prepared(scan_pairs, cfg, dev, B):
    src_xyz, src_mask, tgt_xyz, tgt_mask = (t[:B].to(dev) for t in scan_pairs)
    src = apdgicp.prepare(src_xyz, src_mask, cfg, device=dev)
    tgt = apdgicp.prepare(tgt_xyz, tgt_mask, cfg, device=dev)
    return src, tgt, torch.eye(4, device=dev).expand(B, 4, 4).contiguous()


@pytest.mark.parametrize("B", [1, 3, 256])
@pytest.mark.parametrize("case", list(STORE_CASES))
def test_register_dispatch_without_graphs_equals_eager(dev, scan_pairs, fresh_store, case, B):
    """``register_dispatch`` handed no graphs on the card, three
    registrations of one key: the first runs eagerly and captures nothing,
    the second captures the key's two graphs once and replays them, the
    third replays; each gives bitwise what ``eager=True`` gives, in every
    result field (the third on another problem of the same shapes)."""
    cfg = RegistrationConfig(**STORE_CASES[case])
    src, tgt, guess = _prepared(scan_pairs, cfg, dev, B)
    seen = []
    for s, t in ((src, tgt), (src, tgt), (tgt, src)):
        got = apdgicp.register_dispatch(s, t, guess, cfg, device=dev)
        with cuda_graph.cusolver():
            want = apdgicp.register_dispatch(s, t, guess, cfg, device=dev, eager=True)
        torch.cuda.synchronize()
        for field in dataclasses.fields(want):
            assert torch.equal(getattr(got, field.name), getattr(want, field.name)), field.name
        store = apdgicp._graphs
        seen.append((len(store.cache.graphs), store.replays, int(want.iterations.max())))
    assert seen[0][:2] == (0, 0)
    assert seen[1][0] == 1 and seen[1][1] == seen[1][2] + 1  # the iterations, then the final step
    assert seen[2][0] == 1 and seen[2][1] == seen[1][1] + seen[2][2] + 1


def test_the_store_keeps_the_newest_four_keys(dev, scan_pairs, fresh_store):
    """Five keys (B = 1..5), each registered twice: five captures, and the
    store holds the newest four; the oldest key's next registration runs
    eagerly, as a first sighting."""
    cfg = RegistrationConfig(use_pallas_correspondence=True)
    problems = {B: _prepared(scan_pairs, cfg, dev, B) for B in range(1, 6)}
    for B, (src, tgt, guess) in problems.items():
        for _ in range(2):
            apdgicp.register_dispatch(src, tgt, guess, cfg, device=dev)
    store = apdgicp._graphs
    assert sorted(k[3][0] for k in store.cache.graphs) == [2, 3, 4, 5]
    replays = store.replays
    apdgicp.register_dispatch(*problems[1], cfg, device=dev)
    assert store.replays == replays and sorted(k[3][0] for k in store.cache.graphs) == [2, 3, 4, 5]


def test_loop_verification_through_the_store_equals_its_bypass(dev, scan_pairs, fresh_store, monkeypatch):
    """``detector.verify_loops_batch`` at B=3 (garden's ``verify_candidates``)
    under the cp preset's registration: eager, captured, then replayed
    through the module's store, each the same ``res``, ``ok`` and ``best``
    as with the store bypassed."""
    from rivslam_tpu_torch.loop import detector

    cfg = presets.get("cp")
    reg_cfg = dataclasses.replace(cfg.registration, use_pallas_correspondence=True)
    src_xyz, src_mask, tgt_xyz, tgt_mask = (t[:3].to(dev) for t in scan_pairs)
    yaws = torch.tensor([0.0, 0.05, -0.05], device=dev)
    valid = torch.ones(3, dtype=torch.bool, device=dev)
    args = (src_xyz[0], src_mask[0], tgt_xyz, tgt_mask, yaws, valid, reg_cfg, cfg.loop)
    with monkeypatch.context() as m, cuda_graph.cusolver():
        m.setattr(apdgicp, "_module_graphs", lambda: None)
        want_res, want_ok, want_best = detector.verify_loops_batch(*args)
    for _ in range(3):
        res, ok, best = detector.verify_loops_batch(*args)
        for field in dataclasses.fields(want_res):
            assert torch.equal(getattr(res, field.name), getattr(want_res, field.name)), field.name
        assert torch.equal(ok, want_ok) and int(best) == int(want_best)
    assert len(apdgicp._graphs.cache.graphs) == 1 and apdgicp._graphs.replays > 0


# ---- the asynchronous loop worker beside the frame path --------------------------

# tests/test_torch_engine_loop.py's loop course and configuration (66 frames
# at capacity 256, one loop closed near the end), rebuilt here without JAX
LOOP_COURSE = dict(seed=21, radius=3.0, omega=2.0 / 3.0, dt=0.15, n_frames=66, capacity=256,
                   world_points=20000, extent=30.0)
LOOP_IMU_CAP = 32


def _loop_cfg(capacity=256):
    cfg = presets.get("cp")
    return dataclasses.replace(
        cfg,
        floor=dataclasses.replace(cfg.floor, floor_pts_thresh=50 * capacity // 1024),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
        backend=dataclasses.replace(cfg.backend, window_size=3, max_solver_iterations=4),
        loop=dataclasses.replace(
            cfg.loop, accum_distance_thresh=8.0, min_loop_interval_dist=2.0,
            max_yaw_difference_deg=45.0, odom_drift_xy=0.15, sc_dist_thresh=0.7,
            keyframe_capacity=64, loop_capacity=8,
        ),
    )


def _async(cfg):
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, async_loop=True))


def test_capture_waits_for_a_worker_job(dev, monkeypatch):
    """A graph capture started while a worker job runs waits for it (the
    capture lock), and both finish: the job's kernels neither fail the
    capture nor land in it."""
    eng = pipeline.Engine(_async(_loop_cfg()), device=dev)
    started, release = threading.Event(), threading.Event()
    done = []

    def busy_job(snap):
        started.set()
        x = torch.randn(256, 256, device=dev)
        for _ in range(50):
            x = torch.tanh(x @ x.T * 1e-3)
        release.wait(timeout=10.0)
        done.append(float(x.sum()))  # a host read on the worker's stream
        return None

    monkeypatch.setattr(eng, "_run_loop_detection", busy_job)
    eng._submit_loop_job({"k": 1, "epoch": 0})
    assert started.wait(timeout=10.0)
    a = torch.ones(64, device=dev)
    timer = threading.Timer(0.3, release.set)
    timer.start()
    g = cuda_graph.Graphed("capture beside a worker job", lambda t: (t * 2.0,), [a])
    assert done, "the capture did not wait for the worker's job"
    assert torch.equal(g.replay()[0], a * 2.0)
    eng.drain_loops()
    eng.close()


def test_worker_launches_are_counted_apart(dev):
    """The worker's K1/K3 launches go to ``worker_launches``, the frame
    path's to ``launches``, none lost: a free-running async run over the
    loop course closes its loop with worker launches counted, and its frame
    path counts as the synchronous run's."""
    from rivslam_tpu_torch.ops import nn_argmin, nn_gather

    seq, _ = synthetic.simulate_sequence(**LOOP_COURSE)
    cap = LOOP_COURSE["capacity"]
    cfg = _loop_cfg(cap)
    counts = {}
    for name, c in (("sync", cfg), ("async", _async(cfg))):
        eng = pipeline.Engine(c, device=dev)
        for fn in (nn_gather.fused_gather, nn_argmin.nearest_neighbor):
            fn.launches = fn.worker_launches = 0
        datasets.replay(eng, seq, cap, LOOP_IMU_CAP, progress=lambda i, n: eng.drain_loops())
        counts[name] = {fn.__name__: (fn.launches, fn.worker_launches)
                        for fn in (nn_gather.fused_gather, nn_argmin.nearest_neighbor)}
        eng.close()
    assert counts["sync"]["fused_gather"][1] == 0
    assert counts["async"]["fused_gather"][1] > 0 and counts["async"]["nearest_neighbor"][1] > 0
    for fn in ("fused_gather", "nearest_neighbor"):
        assert sum(counts["async"][fn]) == counts["sync"][fn][0], (fn, counts)


def _loop_edges(eng) -> dict:
    g = eng.state.graph
    m = g.loop_mask
    return {"i": g.loop_i[m], "j": g.loop_j[m], "R": g.loop_rel_R[m], "p": g.loop_rel_p[m],
            "info": g.loop_info[m]}


def test_async_worker_through_the_store_closes_the_inline_loops(dev, monkeypatch):
    """The loop course with the module's store emptied before each run:
    inline (the first verification eager, the second captures), then on the
    async worker drained after every frame (the first two eager, the
    second's capture made on the frame's thread as it merges the job, then
    replays on the worker's thread and stream): the same loop edges bitwise
    and the same K1 launches in all (frame path and worker);
    free-running, the frame's thread goes on while the worker replays, and
    the run ends with a loop closed and the worker's verifications
    graphed."""
    from rivslam_tpu_torch.eval import timing

    # 100 frames: past the loop closure the pairwise check rejects more
    # verified candidates (17 in a CPU run; at 84 frames the card verified
    # 4 inline and 2 free-running), so the store captures and replays
    seq, _ = synthetic.simulate_sequence(**{**LOOP_COURSE, "n_frames": 100})
    cap = LOOP_COURSE["capacity"]
    cfg = _loop_cfg(cap)
    edges, regs, k1 = {}, {}, {}
    for name, c, drain in (("inline", cfg, True), ("drained", _async(cfg), True), ("free", _async(cfg), False)):
        monkeypatch.setattr(apdgicp, "_graphs", None)
        tracer = timing.StageTimers().on()
        try:
            eng = pipeline.Engine(c, device=dev, timers=tracer)
            nn_gather.fused_gather.launches = nn_gather.fused_gather.worker_launches = 0
            datasets.replay(eng, seq, cap, LOOP_IMU_CAP,
                            progress=(lambda i, n: eng.drain_loops()) if drain else None)
            eng.drain_loops()
        finally:
            tracer.off()
        totals = tracer.totals()
        regs[name] = tuple(totals[c_].get("engine.loop_detection", 0)
                           for c_ in ("registrations_graphed", "registrations_eager"))
        k1[name] = nn_gather.fused_gather.launches + nn_gather.fused_gather.worker_launches
        edges[name] = _loop_edges(eng)
        eng.close()
    graphed, eager = regs["inline"]
    assert eager == 1 and graphed >= 2, regs
    assert regs["drained"] == (graphed - 1, 2) and k1["drained"] == k1["inline"], (regs, k1)
    for key, want in edges["inline"].items():
        assert torch.equal(edges["drained"][key], want), key
    assert len(edges["inline"]["i"]) >= 1
    assert regs["free"][1] == 2 and regs["free"][0] >= 1 and len(edges["free"]["i"]) >= 1, (regs, edges["free"])


def test_scan_to_map_graph_pair(dev):
    """The garden preset's Engine captures a second registration graph pair
    for the scan-to-map shape (N against max_submap_frames x N), and K1 is
    credited through both pairs' replays."""
    from rivslam_tpu_torch.ops import nn_gather

    cfg = presets.get("garden")
    cfg = dataclasses.replace(cfg, registration=dataclasses.replace(
        cfg.registration, use_pallas_correspondence=True))
    seq, _ = synthetic.simulate_sequence(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=8,
                                         capacity=1024, world_points=20000, extent=30.0)
    eng = pipeline.Engine(cfg, device=dev)
    nn_gather.fused_gather.launches = 0
    datasets.replay(eng, seq, 1024, 64)
    shapes = sorted(eng.reg_graphs.launches_by_shape())
    S = cfg.odometry.max_submap_frames
    assert shapes == [(1, 1024, 1024), (1, 1024, S * 1024)], shapes
    credited = sum(n.get("K1", 0) for n in eng.reg_graphs.launches_by_shape().values())
    assert credited == nn_gather.fused_gather.launches > 0


def test_replay_on_the_card_equals_process_frame(dev):
    """Engine.replay_sequence on the card: bitwise the process_frame loop of
    the same loop-off configuration and seed (the same frame step, the
    Engine's graphs), K1 and K3 launched; a fleet of two equals its single
    replays."""
    seq, _ = synthetic.simulate_sequence(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=6,
                                         capacity=1024, world_points=20000, extent=30.0)
    cfg = presets.get("cp")
    cfg = dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, enable=False),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )
    outs = datasets.replay(pipeline.Engine(cfg, seed=0, device=dev), seq, 1024, 64)
    stacked = datasets.stack_sequence(seq, 1024, 64)
    k1, k3 = nn_gather.fused_gather.launches, nn_argmin.nearest_neighbor.launches
    rep = pipeline.Engine(cfg, seed=0, device=dev).replay_sequence(stacked)
    assert nn_gather.fused_gather.launches > k1 and nn_argmin.nearest_neighbor.launches > k3
    np.testing.assert_array_equal(rep["pose"], np.stack([o["pose"] for o in outs]))
    np.testing.assert_array_equal(rep["is_keyframe"], [o["is_keyframe"] for o in outs])
    batch = {k: np.stack([v[:3], v[3:]]) for k, v in stacked.items()}
    fleet = pipeline.Engine(cfg, seed=1, device=dev).replay_fleet(batch)
    for b in range(2):
        single = pipeline.Engine(cfg, device=dev)
        single.key = prng.fold_in(prng.key(1), b)
        one = single.replay_sequence({k: v[b] for k, v in batch.items()})
        np.testing.assert_array_equal(fleet["pose"][b], one["pose"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_draw_equals_cpu_draw(dev, dtype):
    """The Engine's RANSAC draw (core/prng.uniform) computed on the card is
    the CPU's bit for bit, one key and a stack of keys, at the engine's
    shape (128 hypotheses x capacity 1024)."""
    _, keys = prng.split_chain(prng.key(0), 3)
    for draw in (lambda d: prng.uniform(keys[0], (128, 1024), dtype, d),
                 lambda d: prng.uniform_stack(keys, (128, 1024), dtype, d)):
        on_card, on_cpu = draw(dev).cpu(), draw("cpu")
        assert on_card.dtype == on_cpu.dtype == dtype
        assert torch.equal(on_card.view(torch.uint8), on_cpu.view(torch.uint8))


def test_engine_frame_draw_is_the_cpu_draw(dev):
    """The Engine's per-frame draw on the card, its CUDA graph replayed for
    each frame's key, is the CPU's draw bit for bit."""
    _, keys = prng.split_chain(prng.key(0), 3)
    eng = pipeline.Engine(presets.get("cp"), device=dev)
    for k in keys:
        on_card = eng._frame_draw(k, (128, 1024)).cpu()
        assert torch.equal(on_card.view(torch.int32), prng.uniform(k, (128, 1024)).view(torch.int32))
    assert eng._draw_graphs.graphs[1024].replays == len(keys)


@pytest.fixture
def nccl_world(dev, tmp_path):
    """A NCCL process group of one rank and its (1, 1) mesh."""
    from rivslam_tpu_torch.dist import mesh as mesh_mod

    mesh_mod.init_world("nccl", 0, 1, str(tmp_path / "init"), timeout_s=60.0)
    try:
        yield mesh_mod.make_mesh(1, 1)
    finally:
        torch.distributed.destroy_process_group()


def _exact_pairs(dev, B):
    cfg = RegistrationConfig(use_fast_path=False)
    *data, _ = synthetic.load_pairs(B, 512, device=dev)
    src, tgt = (apdgicp.prepare(x, m, cfg, device=dev) for x, m in (data[:2], data[2:]))
    return src, tgt, torch.eye(4, device=dev).expand(B, 4, 4).contiguous(), cfg


@pytest.mark.parametrize("which", ["batched_register", "sharded_register"])
def test_distributed_registration_runs_through_k2(dev, nccl_world, which):
    """On a world of one rank both distributed registrations launch K2 and
    equal the local ``register`` bitwise."""
    from rivslam_tpu_torch.dist import dist_gn

    B = 8 if which == "batched_register" else 1
    src, tgt, guess, cfg = _exact_pairs(dev, B)
    nn_corr.fused_correspondence.launches = 0
    got = getattr(dist_gn, which)(src, tgt, guess, cfg, nccl_world)
    torch.cuda.synchronize()
    assert nn_corr.fused_correspondence.launches > 0
    want = apdgicp.register(src, tgt, guess, cfg)
    for f in ("T", "H", "error", "converged", "iterations", "num_correspondences", "fitness"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_distributed_window_solve_is_one_launch(dev, nccl_world):
    """``batched_window_solve`` on a world of one rank: its B windows in one
    launch of the window kernel, equal to ``solve_batched`` on the batch."""
    from rivslam_tpu_torch.dist import dist_gn
    from rivslam_tpu_torch.solver import window
    from torch_window_problem import BIAS_INFO, make_window

    probs = [make_window(seed=s, dtype=torch.float32, device=dev) for s in (1, 2)]
    x = window.WindowState(*(torch.stack(ts) for ts in zip(*(p[0].astuple() for p in probs))))
    f = type(probs[0][1])(**{
        fl.name: (type(getattr(probs[0][1], fl.name))(*(torch.stack(ts) for ts in zip(
            *(getattr(p[1], fl.name).astuple() for p in probs))))
                  if dataclasses.is_dataclass(getattr(probs[0][1], fl.name))
                  else torch.stack([getattr(p[1], fl.name) for p in probs]))
        for fl in dataclasses.fields(probs[0][1])})
    bk = _window_cfg()
    launches = window.solve_batched.launches
    xs, chi2, iters = dist_gn.batched_window_solve(x, f, bk, BIAS_INFO, nccl_world)
    torch.cuda.synchronize()
    assert window.solve_batched.launches - launches == 1
    want_x, want_chi2, counts = window.solve_batched(x, f, bk, BIAS_INFO)
    assert torch.equal(iters, counts[:, 0]) and torch.equal(chi2, want_chi2)
    for a, b in zip(xs.astuple(), want_x.astuple()):
        assert torch.equal(a, b)
