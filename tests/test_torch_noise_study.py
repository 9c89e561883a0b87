"""The port's APDGICP-against-GICP noise study
(``rivslam_tpu_torch/eval/noise_study.py``) against the JAX package's
(``rivslam_tpu/eval/noise_study.py``) on the CPU.

The reference builds its trial pairs in float32 and registers each
method's batch with the vmapped ``apdgicp.prepare_and_register``. Here the
port's ``run_trials`` runs in float64, 3 trials at capacity 256, with its
study configuration (the reference's, K1 on), and the reference's steps run
on the same pairs in float64: the reference's own ``pose_error`` over the
vmapped JAX registration. The statistics agree within 1e-6 m and 1e-4
deg.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shared_cache  # noqa: F401  (one torch thread per test process)

from rivslam_tpu.core import lie as ref_lie
from rivslam_tpu.core.config import RegistrationConfig as RefRegConfig
from rivslam_tpu.eval import noise_study as ref_ns
from rivslam_tpu.frontend import apdgicp as ref_apdgicp
from rivslam_tpu.io import synthetic as ref_syn
from rivslam_tpu_torch.eval import noise_study

TRIALS, CAP = 3, 256


def _ref_cfgs():
    """The reference study's configurations (its XLA correspondence step)."""
    return (RefRegConfig(method="FAST_APDGICP", transformation_epsilon=5e-4),
            RefRegConfig(method="FAST_GICP", transformation_epsilon=5e-4))


def _cfgs():
    """The port's study configurations: the same, with K1 on (its plain
    twin on the CPU; it averages exact ties, which float64 scans do not
    hold)."""
    return noise_study.study_cfg("FAST_APDGICP"), noise_study.study_cfg("FAST_GICP")


def test_study_cfgs_are_the_references_with_k1_on():
    for got, want in zip(_cfgs(), _ref_cfgs()):
        assert got.use_pallas_correspondence
        assert dataclasses.asdict(dataclasses.replace(got, use_pallas_correspondence=False)) == \
            dataclasses.asdict(want)


def test_pose_error_matches_reference():
    rng = np.random.default_rng(1)
    for _ in range(3):
        T = np.asarray(ref_lie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.1)))
        U = np.asarray(ref_lie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.1)))
        assert noise_study.pose_error(T, U) == ref_ns.pose_error(T, U)


def test_trial_pairs_are_the_reference_scans():
    """The port's trial 1 is the reference's: the same world, poses and
    spherical-noise observations from the trial's seed."""
    cfg_apd, _ = _cfgs()
    sx, sm, tx, tm, rels = noise_study.trial_pairs(2, "spherical", cfg_apd, CAP, 56.5, 0, 0.02,
                                                   torch.float64, "cpu")
    rng = np.random.default_rng(1)
    world = ref_syn.make_world(rng, n_points=8000)
    T0 = np.eye(4)
    T0[:3, 3] = [rng.uniform(-5, 5), rng.uniform(-5, 5), 2.0]
    xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.4, 0.4, 3)])
    T_rel = np.asarray(ref_lie.se3_exp(jnp.asarray(xi)))
    kw = dict(capacity=CAP, fov_deg=56.5, dtype=jnp.float64, noise=0.0, range_noise_rel=cfg_apd.dist_var / 400.0,
              az_noise_deg=cfg_apd.azimuth_var, el_noise_deg=cfg_apd.elevation_var)
    tgt = ref_syn.observe(world, T0, rng, **kw)
    src = ref_syn.observe(world, T0 @ T_rel, rng, **kw)
    np.testing.assert_allclose(rels[1], T_rel, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tm[1].numpy(), np.asarray(tgt.mask))
    np.testing.assert_array_equal(sm[1].numpy(), np.asarray(src.mask))
    np.testing.assert_allclose(tx[1].numpy(), np.asarray(tgt.xyz), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sx[1].numpy(), np.asarray(src.xyz), rtol=0, atol=1e-12)


@pytest.mark.parametrize("noise_model", ["cartesian", "spherical"])
def test_run_trials_matches_reference_float64(noise_model):
    cfg_apd, cfg_gicp = _cfgs()
    got = noise_study.run_trials(TRIALS, noise_model, cfg_apd, cfg_gicp, capacity=CAP,
                                 dtype=torch.float64, device="cpu")
    assert got["noise_model"] == noise_model and got["trials"] == TRIALS
    sx, sm, tx, tm, rels = noise_study.trial_pairs(TRIALS, noise_model, cfg_apd, CAP, 56.5, 0, 0.02,
                                                   torch.float64, "cpu")
    args = [jnp.asarray(t.numpy()) for t in (sx, sm, tx, tm)] + [jnp.eye(4, dtype=jnp.float64)[None].repeat(TRIALS, 0)]
    for name, cfg in zip(("FAST_APDGICP", "FAST_GICP"), _ref_cfgs()):
        Ts = np.asarray(jax.jit(jax.vmap(
            lambda a, b, c, d, g: ref_apdgicp.prepare_and_register(a, b, c, d, g, cfg).T))(*args))
        errs = np.array([ref_ns.pose_error(Ts[i], rels[i]) for i in range(TRIALS)])
        want = {"trans_rmse_m": np.sqrt(np.mean(errs[:, 0] ** 2)), "trans_median_m": np.median(errs[:, 0]),
                "rot_rmse_deg": np.sqrt(np.mean(errs[:, 1] ** 2)), "rot_median_deg": np.median(errs[:, 1])}
        for key, value in want.items():
            atol = 1e-6 if key.startswith("trans") else 1e-4
            np.testing.assert_allclose(got[name][key], value, rtol=0, atol=atol, err_msg=f"{name} {key}")
        assert all(np.isfinite(v) for v in got[name].values())
        assert got[name]["k1_launches"] == 0  # the plain twin ran: no card here
