"""The port's CUDA kernels (K1, K3) on the card, against their plain twins,
and the paths that launch them.

Needs an NVIDIA GPU with nvcc; everywhere else every test skips. Run on the
card, without the JAX test harness:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import rivslam_tpu_torch
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp
from rivslam_tpu_torch.io import synthetic
from rivslam_tpu_torch import pipeline, presets
from rivslam_tpu_torch.io import datasets
from rivslam_tpu_torch.ops import nn_argmin, nn_gather

pytestmark = pytest.mark.cuda

# d2 from the same separately rounded operations in both: equal up to the
# relative bound; features of a winner are copied, ties are means of a few
D2_RTOL, D2_ATOL, G_ATOL = 1e-4, 1e-6, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    nn_gather.build()
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
    backend's fitness), K1 in every registration LM step, finite poses."""
    seq, _ = synthetic.simulate_sequence(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=4,
                                         capacity=1024, world_points=20000, extent=30.0)
    cfg = presets.get("cp")
    cfg = dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, enable=False),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )
    k1, k3 = nn_gather.fused_gather.launches, nn_argmin.nearest_neighbor.launches
    outs = datasets.replay(pipeline.Engine(cfg, device=dev), seq, 1024, 64)
    assert nn_argmin.nearest_neighbor.launches - k3 == 4
    assert nn_gather.fused_gather.launches - k1 >= 3
    assert all(np.isfinite(o["pose"]).all() for o in outs)
