"""Controlled APDGICP-against-GICP noise-model study (port of
``rivslam_tpu/eval/noise_study.py``).

    python -m rivslam_tpu_torch.eval.noise_study [--trials 20]
        [--capacity 1024] [--sweep] [--cpu]

Pairwise registration over many trials under (a) isotropic Cartesian noise,
the model plain GICP assumes, and (b) the radar-realistic spherical model
with parameters matched to the adaptive covariance (range_noise_rel =
dist_var/400, angular sigmas = azimuth/elevation_var, the launch file's
dist_var 0.86 and 1 deg, radar_graph_slam.launch:34-36). The adaptive
probability-distribution covariance (fast_apdgicp_impl.hpp:163-184) models
(b); under (a) it claims tangential variance that is not there.

Every trial pair is built on the host from its own seed, then each method
registers the whole batch of trials in one ``apdgicp.prepare_and_register``
call: FAST_APDGICP and FAST_GICP on the fast path, whose correspondence
step is K1 at B = trials. The card is the default; ``--cpu`` runs on the
host. Each JSON line names the device under "device" (on the card its
name and power limit).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from rivslam_tpu_torch.core.config import RegistrationConfig
from rivslam_tpu_torch.core.device import resolve


def pose_error(T_est: np.ndarray, T_true: np.ndarray) -> tuple[float, float]:
    """(translation error in m, rotation error in deg) of T_est against
    T_true, in float64 on the host (a float32 arccos rounds sub-0.05 deg
    errors to 0)."""
    delta = np.linalg.inv(np.asarray(T_est, np.float64)) @ np.asarray(T_true, np.float64)
    dt = float(np.linalg.norm(delta[:3, 3]))
    cosang = np.clip((np.trace(delta[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return dt, float(np.degrees(np.arccos(cosang)))


def trial_pairs(n_trials: int, noise_model: str, cfg_apd: RegistrationConfig, capacity: int,
                fov_deg: float, seed: int, cartesian_noise: float, dtype, device):
    """The trials' scan pairs, stacked: (source xyz [T,N,3], source mask,
    target xyz, target mask, true relative poses [T,4,4] as numpy)."""
    from rivslam_tpu_torch.core import lie
    from rivslam_tpu_torch.io import synthetic

    kw: dict = dict(capacity=capacity, fov_deg=fov_deg, dtype=dtype, device=device)
    if noise_model == "cartesian":
        kw["noise"] = cartesian_noise
    elif noise_model == "spherical":
        # the generative model matched to the launch file's adaptive parameters
        kw.update(noise=0.0, range_noise_rel=cfg_apd.dist_var / 400.0,
                  az_noise_deg=cfg_apd.azimuth_var, el_noise_deg=cfg_apd.elevation_var)
    else:
        raise ValueError(noise_model)
    srcs, tgts, rels = [], [], []
    for trial in range(n_trials):
        rng = np.random.default_rng(seed + trial)
        world = synthetic.make_world(rng, n_points=8000)
        T0 = np.eye(4)
        T0[:3, 3] = [rng.uniform(-5, 5), rng.uniform(-5, 5), 2.0]
        xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.4, 0.4, 3)])
        T_rel = lie.se3_exp(torch.as_tensor(xi)).numpy()
        tgts.append(synthetic.observe(world, T0, rng, **kw))
        srcs.append(synthetic.observe(world, T0 @ T_rel, rng, **kw))
        rels.append(T_rel)
    return (torch.stack([c.xyz for c in srcs]), torch.stack([c.mask for c in srcs]),
            torch.stack([c.xyz for c in tgts]), torch.stack([c.mask for c in tgts]), np.stack(rels))


def run_trials(
    n_trials: int,
    noise_model: str,
    cfg_apd: RegistrationConfig,
    cfg_gicp: RegistrationConfig,
    capacity: int = 1024,
    fov_deg: float = 56.5,
    seed: int = 0,
    cartesian_noise: float = 0.02,
    dtype=torch.float32,
    device="cuda",
) -> dict:
    """Register n_trials independent scan pairs under the noise model, each
    method's trials as one batch; per-method translation and rotation error
    statistics. float32 is the production dtype: the study isolates the
    covariance model, not the numerics (errors are ~1e-1 m)."""
    from rivslam_tpu_torch.frontend import apdgicp
    from rivslam_tpu_torch.ops import nn_gather

    dev = resolve(device)
    sx, sm, tx, tm, rels = trial_pairs(n_trials, noise_model, cfg_apd, capacity, fov_deg, seed,
                                       cartesian_noise, dtype, dev)
    eye = torch.eye(4, dtype=dtype, device=dev).expand(n_trials, 4, 4)
    out = {"noise_model": noise_model, "trials": n_trials}
    for name, cfg in (("FAST_APDGICP", cfg_apd), ("FAST_GICP", cfg_gicp)):
        k1 = nn_gather.fused_gather.launches
        Ts = apdgicp.prepare_and_register(sx, sm, tx, tm, eye, cfg, device=dev).T.cpu().numpy()
        errs = [pose_error(Ts[i], rels[i]) for i in range(n_trials)]
        dts = np.array([e[0] for e in errs])
        drs = np.array([e[1] for e in errs])
        out[name] = {
            "trans_rmse_m": float(np.sqrt(np.mean(dts**2))),
            "trans_median_m": float(np.median(dts)),
            "rot_rmse_deg": float(np.sqrt(np.mean(drs**2))),
            "rot_median_deg": float(np.median(drs)),
            "k1_launches": nn_gather.fused_gather.launches - k1,  # the card's kernel; 0 on the CPU
        }
    return out


def study_cfg(method: str, **kw) -> RegistrationConfig:
    """The study's registration: the launch file's runtime parameters
    (radar_graph_slam.launch:34-36), with the fused correspondence kernel
    K1 on."""
    return RegistrationConfig(method=method, transformation_epsilon=5e-4, use_pallas_correspondence=True, **kw)


def main(argv=None) -> int:
    from rivslam_tpu_torch.eval.latency import _card

    ap = argparse.ArgumentParser(prog="rivslam_tpu_torch.eval.noise_study")
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--sweep", action="store_true", help="also sweep az/el var")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    args = ap.parse_args(argv)
    dev = resolve("cpu" if args.cpu else "cuda")
    card = _card(dev)

    cfg_apd, cfg_gicp = study_cfg("FAST_APDGICP"), study_cfg("FAST_GICP")
    for model in ("cartesian", "spherical"):
        r = run_trials(args.trials, model, cfg_apd, cfg_gicp, capacity=args.capacity, device=dev)
        print(json.dumps({**r, "device": card}))
    if args.sweep:
        for var in (0.25, 0.5, 1.0, 2.0):
            cfg = study_cfg("FAST_APDGICP", azimuth_var=var, elevation_var=var)
            r = run_trials(args.trials, "spherical", cfg, cfg_gicp, capacity=args.capacity, device=dev)
            print(json.dumps({**r, "az_el_var_deg": var, "device": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
