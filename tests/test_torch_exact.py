"""The port's exact registration path (``frontend/apdgicp``:
``estimate_covariances``, ``_correspondences`` through K2's plain twin,
``register`` under LM and GN, and the method dispatch) against the JAX
package on the CPU, and the engine running on it.

Inputs are ``entry()``'s example pair (capacity 256) and bench.py's frame
pairs, made with numpy and fed to both packages; the engine runs
tests/test_torch_engine_loop.py's configuration on the cp course's circle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shared_cache  # noqa: F401  (one torch thread per test process)

import rivslam_tpu_torch
from rivslam_tpu.core.config import RegistrationConfig as RefConfig
from rivslam_tpu.frontend import apdgicp as ref_apdgicp
from rivslam_tpu_torch import convert
from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.frontend import apdgicp, apdgicp_fast
from rivslam_tpu_torch.io import synthetic
from test_torch_engine_loop import LOOP_COURSE, POSE_ATOL_F64, _run_both, _stack

CPU = "cpu"
# registration parity: the packages sum H/b in different orders, so T agrees
# to float32 round-off amplified by the LM solve (as tests/test_torch_apdgicp.py)
T_ATOL = 1e-3
COV_ATOL_F64 = 1e-5


def _ref_cfg(cfg: RegistrationConfig) -> RefConfig:
    return RefConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def entry_pair():
    _, args = rivslam_tpu_torch.entry(device=CPU)
    return [a.numpy() for a in args]


@pytest.fixture(scope="module")
def pairs():
    src_xyz, src_mask, tgt_xyz, tgt_mask, rel = synthetic.load_pairs(3, 256, device=CPU)
    return [t.numpy() for t in (src_xyz, src_mask, tgt_xyz, tgt_mask)], rel


def _plane_defined(cov64):
    """Rows whose unregularized covariance has a smallest eigenvalue clear
    of the next (gap > 1e-6): elsewhere the plane normal is rounding noise
    in any implementation (a lone point's RBF moments)."""
    lam = np.linalg.eigvalsh(cov64)
    return (lam[..., 1] - lam[..., 0]) > 1e-6


@pytest.mark.parametrize("reg", ["NONE", "PLANE", "MIN_EIG", "NORMALIZED_MIN_EIG"])
@pytest.mark.parametrize("method", ["KNN", "RBF"])
def test_estimate_covariances_match_reference(pairs, method, reg):
    """Float64 through both packages, every regularization, within 1e-5."""
    (src_xyz, src_mask, _, _), _ = pairs
    xyz = src_xyz.astype(np.float64)
    cfg = RegistrationConfig(covariance_method=method, regularization=reg, use_fast_path=False)

    def ref(c):
        return np.asarray(jax.jit(jax.vmap(
            lambda x, m: ref_apdgicp.estimate_covariances(x, m, _ref_cfg(c)).cov
        ))(jnp.asarray(xyz), jnp.asarray(src_mask)))

    want = ref(cfg)
    got = apdgicp.prepare(xyz, src_mask, cfg, device=CPU).cov.numpy()
    rows = src_mask.copy()
    if reg == "PLANE":
        rows &= _plane_defined(ref(dataclasses.replace(cfg, regularization="NONE")))
        assert rows.sum() >= 0.8 * src_mask.sum()
    np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=COV_ATOL_F64)


@pytest.mark.parametrize("method", ["ICP", "GICP", "FAST_APDGICP"])
def test_correspondences_match_reference(entry_pair, method):
    """One correspondence step at a perturbed pose: the nearest target is
    the same for every source point, and so are the gate and the weights."""
    src_xyz, src_mask, tgt_xyz, tgt_mask, _ = entry_pair
    cfg = RegistrationConfig(method=method, use_fast_path=False)
    rcfg = _ref_cfg(cfg)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.1, 0.02]
    rs = ref_apdgicp.prepare(jnp.asarray(src_xyz), jnp.asarray(src_mask), rcfg)
    rt = ref_apdgicp.prepare(jnp.asarray(tgt_xyz), jnp.asarray(tgt_mask), rcfg)
    idx, corr, mah, d2 = ref_apdgicp._correspondences(jnp.asarray(T), rs, rt, rcfg)
    src = apdgicp.prepare(src_xyz[None], src_mask[None], cfg, device=CPU)
    tgt = apdgicp.prepare(tgt_xyz[None], tgt_mask[None], cfg, device=CPU)
    sent = torch.where(tgt.mask[..., None], tgt.xyz, 1e6)
    feats = torch.cat([tgt.xyz, tgt.cov.reshape(1, -1, 9)], dim=-1)
    c = apdgicp._correspondences(torch.as_tensor(T)[None], src, sent, tgt.mask, feats, cfg)
    np.testing.assert_array_equal(c.idx[0].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(c.corr[0].numpy(), np.asarray(corr))
    np.testing.assert_array_equal(c.tgt[0].numpy(), tgt_xyz[np.asarray(idx)])
    ok = np.asarray(corr)
    np.testing.assert_allclose(c.d2[0].numpy()[ok], np.asarray(d2)[ok], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(c.mah[0].numpy(), np.asarray(mah), rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("optimizer", ["LM", "GN"])
@pytest.mark.parametrize("method", ["ICP", "GICP", "FAST_APDGICP"])
def test_exact_register_matches_reference(entry_pair, method, optimizer):
    """``use_fast_path=False`` on entry()'s pair: T within 1e-3, and the
    correspondences, iterations and convergence equal."""
    cfg = RegistrationConfig(method=method, optimizer=optimizer, use_fast_path=False)
    want = jax.jit(
        lambda *a: ref_apdgicp.prepare_and_register(*a, _ref_cfg(cfg))
    )(*map(jnp.asarray, entry_pair))
    got = apdgicp.prepare_and_register(*entry_pair, cfg, device=CPU)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=0, atol=T_ATOL)
    assert int(got.num_correspondences) == int(want.num_correspondences)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-3, atol=1e-5)


def test_exact_register_batched_matches_separate_reference_calls(pairs):
    """B=3 problems in one batched loop against three separate reference
    calls (APDGICP without the fast path: no adaptive term, as in the
    reference). The reference runs op by op: under jit, XLA fuses the RBF
    moments differently and moves float32 covariances of isolated points
    by rounding noise (tests/test_torch_apdgicp.py, float32 prepare)."""
    (src_xyz, src_mask, tgt_xyz, tgt_mask), rel = pairs
    cfg = RegistrationConfig(method="APDGICP", use_fast_path=False, covariance_method="RBF")
    guess = np.broadcast_to(np.eye(4, dtype=np.float32), (3, 4, 4)).copy()
    want = [
        ref_apdgicp.prepare_and_register(
            *map(jnp.asarray, (src_xyz[b], src_mask[b], tgt_xyz[b], tgt_mask[b], guess[b])),
            _ref_cfg(cfg),
        )
        for b in range(3)
    ]
    got = apdgicp.prepare_and_register(
        src_xyz, src_mask, tgt_xyz, tgt_mask, convert.guess(guess, device=CPU), cfg, device=CPU
    )
    for key in ("iterations", "converged", "num_correspondences"):
        np.testing.assert_array_equal(
            getattr(got, key).numpy(), [np.asarray(getattr(w, key)) for w in want], err_msg=key
        )
    np.testing.assert_allclose(got.T.numpy(), np.stack([w.T for w in want]), rtol=0, atol=T_ATOL)
    terr = np.linalg.norm(got.T.numpy()[:, :3, 3] - rel[:, :3, 3], axis=1)
    assert np.median(terr) < 0.1


ROUTES = [(m, fast) for m in ("FAST_APDGICP", "FAST_GICP", "GICP", "GICP_OMP", "ICP", "APDGICP")
          for fast in (True, False)]


@pytest.mark.parametrize("method,fast", ROUTES)
def test_register_dispatch_routes_as_the_reference(monkeypatch, method, fast):
    """The fast path for the GICP family with use_fast_path, the exact
    ``register`` for everything else (registrations.cpp:38-140)."""
    calls = []
    monkeypatch.setattr(apdgicp_fast, "register_fast", lambda *a: calls.append("fast"))
    monkeypatch.setattr(apdgicp, "register", lambda *a: calls.append("exact"))
    xyz, mask = torch.zeros(1, 8, 3), torch.ones(1, 8, dtype=torch.bool)
    prepared = apdgicp.PreparedCloud(xyz=xyz, mask=mask, cov=torch.eye(3).expand(1, 8, 3, 3))
    cfg = RegistrationConfig(method=method, use_fast_path=fast)
    apdgicp.register_dispatch(prepared, prepared, torch.eye(4)[None], cfg, device=CPU)
    want = "fast" if fast and method in ("FAST_APDGICP", "FAST_GICP", "GICP", "GICP_OMP") else "exact"
    assert calls == [want]


def test_exact_path_engine_matches_reference():
    """The engine with use_fast_path=False (the exact registration, K2's
    plain twin here) for a few frames of the cp course's circle, float64,
    the JAX engine's draws injected."""
    course = dict(LOOP_COURSE, radius=8.0, omega=0.25, n_frames=5)
    (ref_eng, ref), (eng, got) = _run_both(course, use_fast_path=False)
    assert [o["is_keyframe"] for o in got] == [o["is_keyframe"] for o in ref]
    for key in ("pose", "odom"):
        np.testing.assert_allclose(_stack(got, key), _stack(ref, key), rtol=0, atol=POSE_ATOL_F64)
    assert [o["status"]["num_correspondences"] for o in got[1:]] == [
        o["status"]["num_correspondences"] for o in ref[1:]]
