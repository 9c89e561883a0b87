"""Synthetic accuracy-validation matrix (port of ``rivslam_tpu/eval/validation.py``).

The reference's evaluation is dataset replay plus rpg-style trajectory
evaluation (README.md:57,62-63; trajectory export at
radar_graph_slam_nodelet.cpp:1272-1293). The NTU4DRadLM / MineAndForest bags
are not at hand, so each preset gets a radar-realistic simulated course
(``io/synthetic.simulate_sequence``: FoV, spherical measurement noise,
doppler, IMU bias walk, barometer, dynamic objects), replayed through the
full engine and scored with the same alignment and ATE / RE protocol.

    python -m rivslam_tpu_torch.eval.validation [--presets cp,garden,mine]
        [--matchers FAST_APDGICP,FAST_GICP] [--loop on,off] [--json out.json]
        [--cpu]

Per course: the raw odometry keyframe ATE, the loop-optimized keyframe ATE,
the full-frame trajectory ATE (aligned) and the relative error over 40-frame
sub-paths.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

# Course parameters approximate each dataset's regime: handheld carpark and
# garden-cart NTU4DRadLM sequences (open outdoor scenes) against the
# MineAndForest underground runs (confined, multipath and dynamic returns).
# Two laps give at least one revisit for the loop pipeline.
COURSES: dict[str, dict] = {
    # slow handheld loop, dense close-range returns
    "cp": dict(radius=8.0, omega=0.25, dt=0.25, n_frames=120, capacity=1024,
               world_points=20000, extent=30.0),
    # handheld, larger open loop (omega * dt * n over 4 pi: two laps)
    "nyl": dict(radius=12.0, omega=0.17, dt=0.25, n_frames=300, capacity=1024,
                world_points=24000, extent=40.0),
    # cart, faster
    "garden": dict(radius=15.0, omega=0.2, dt=0.25, n_frames=260, capacity=1024,
                   world_points=24000, extent=45.0),
    # underground: confined extent, moving machinery, noisier doppler
    "mine": dict(radius=10.0, omega=0.3, dt=0.25, n_frames=95, capacity=1024,
                 world_points=26000, extent=25.0, n_dynamic=3,
                 doppler_noise=0.08),
    # the 3-lap cp course: repeated revisits force two or more closures,
    # exercising the last_loop_accum gate and the pairwise-consistency
    # chain with real previous loops (loop_detector.cpp:270-297)
    "multiloop": dict(radius=8.0, omega=0.25, dt=0.25, n_frames=300,
                      capacity=1024, world_points=20000, extent=30.0),
}

PRESET_FOR_COURSE = {
    "cp": "cp", "nyl": "nyl", "garden": "garden", "mine": "mine",
    "multiloop": "cp",
}


def _interp_gt(gt_poses: np.ndarray, times: np.ndarray, stamps) -> np.ndarray:
    idx = [int(np.argmin(np.abs(times - s))) for s in stamps]
    return gt_poses[idx]


def build_course_cfg(course: str, method: str = "FAST_APDGICP", loop_on: bool = True,
                     reg_overrides: dict | None = None):
    """The engine configuration of a validation course (shared with
    ``eval/latency.py`` and ``chip_smoke.py``): the course's preset for
    instantaneous synthetic scans (no deskew or under-floor removal),
    ``method`` with ``reg_overrides``, window LM capped at 8 iterations,
    ego-velocity guesses with the EGOVEL fallback, loop gates 40 m / 5 m."""
    from rivslam_tpu_torch import presets

    cfg = presets.get(PRESET_FOR_COURSE[course])
    r = dataclasses.replace
    return r(
        cfg,
        preprocess=r(cfg.preprocess, enable_deskew=False, enable_under_floor_removal=False),
        registration=r(cfg.registration, method=method, **(reg_overrides or {})),
        backend=r(cfg.backend, max_solver_iterations=8),
        loop=r(cfg.loop, enable=loop_on, accum_distance_thresh=min(cfg.loop.accum_distance_thresh, 40.0),
               min_loop_interval_dist=5.0),
        # the EGOVEL fallback: the launch-parity QUIRK branch doubles any
        # rejected delta (nodelet:561-568), which on a hard course turns one
        # bad registration into a pose jump
        odometry=r(cfg.odometry, use_ego_vel=True, thresholding_fallback="EGOVEL"),
    )


def run_course(course: str, method: str = "FAST_APDGICP", loop_on: bool = True, seed: int = 21,
               dtype=None, sim_overrides: dict | None = None, reg_overrides: dict | None = None,
               device="cuda") -> dict:
    """Simulate the course, replay it through the engine, score it."""
    import torch

    from rivslam_tpu_torch import pipeline
    from rivslam_tpu_torch.eval import ate as ate_mod
    from rivslam_tpu_torch.io import datasets, synthetic

    params = dict(COURSES[course])
    params.update(sim_overrides or {})
    seq, _ = synthetic.simulate_sequence(seed=seed, **params)

    cfg = build_course_cfg(course, method, loop_on, reg_overrides)
    eng = pipeline.Engine(cfg, dtype=dtype or torch.float32, device=device)
    outputs = datasets.replay(eng, seq, capacity=params["capacity"])
    eng.close()

    times = seq.gt_stamps
    gt0 = np.linalg.inv(seq.gt_poses[0])
    gt = np.stack([gt0 @ P for P in seq.gt_poses])

    res: dict = {"course": course, "method": method, "loop": loop_on, "frames": int(seq.num_frames),
                 # the registration knobs as resolved (presets ship RBF, width 4.0)
                 "covariance_method": cfg.registration.covariance_method,
                 "rbf_kernel_width": cfg.registration.rbf_kernel_width}
    g = eng.state.graph
    res["loops_closed"] = int(g.loop_mask.sum()) if g is not None else 0
    res["loop_stats"] = dict(eng.loop_stats)

    # raw odometry keyframe ATE (unaligned: a shared start frame)
    odom = np.stack([np.asarray(o["odom"]) for o in outputs])
    kf_stamps = np.asarray(eng.state.kf_stamps)
    odom_kf = _interp_gt(odom, times, kf_stamps)
    gt_kf = _interp_gt(gt, times, kf_stamps)
    res["odom_kf_ate_m"] = ate_mod.ate(odom_kf[:, :3, 3], gt_kf[:, :3, 3], align=False)["rmse"]

    # loop-optimized keyframes
    kf_opt = eng.optimized_keyframe_poses()
    res["opt_kf_ate_m"] = ate_mod.ate(kf_opt[:, :3, 3], gt_kf[:, :3, 3], align=False)["rmse"]

    # the full per-frame trajectory (SE(3)-aligned, rpg protocol)
    ts, full = eng.trajectory()
    gt_full = _interp_gt(gt, times, ts)
    res["full_ate_m"] = ate_mod.ate(full[:, :3, 3], gt_full[:, :3, 3])["rmse"]

    # relative error over 40-frame (~10 s) sub-paths of the full trajectory
    re = ate_mod.relative_error(full, gt_full, delta=min(40, len(full) - 1))
    res["re_trans_rmse_m"] = re["trans_rmse"]
    res["re_rot_rmse_deg"] = re["rot_rmse_deg"]
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="rivslam_tpu_torch.eval.validation")
    ap.add_argument("--presets", default="cp,nyl,garden,mine")
    ap.add_argument("--matchers", default="FAST_APDGICP,FAST_GICP")
    ap.add_argument("--loop", default="on,off")
    ap.add_argument("--seed", default="21", help="seed or comma list (averaged)")
    ap.add_argument("--f64", action="store_true", help="float64 (the CUDA kernels take float32 only)")
    ap.add_argument("--cov", default="KNN", choices=("KNN", "RBF"),
                    help="covariance neighborhood method (RegistrationConfig.covariance_method A/B)")
    ap.add_argument("--rbf-kw", type=float, default=None, help="override rbf_kernel_width (only with --cov RBF)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card; no fallback)")
    args = ap.parse_args(argv)
    import torch

    device = "cpu" if args.cpu else "cuda"
    dtype = torch.float64 if args.f64 else torch.float32
    seeds = [int(s) for s in str(args.seed).split(",")]
    rows = []
    for course in args.presets.split(","):
        for method in args.matchers.split(","):
            for lp in args.loop.split(","):
                per_seed = []
                for sd in seeds:
                    reg_ov = {"covariance_method": args.cov} if args.cov != "KNN" else None
                    if reg_ov is not None and args.rbf_kw is not None:
                        reg_ov["rbf_kernel_width"] = args.rbf_kw
                    r = run_course(course, method, lp == "on", seed=sd, dtype=dtype, reg_overrides=reg_ov,
                                   device=device)
                    per_seed.append(r)
                    print(json.dumps(r), flush=True)
                agg = dict(per_seed[0])
                agg["seeds"] = len(seeds)
                for kk in ("odom_kf_ate_m", "opt_kf_ate_m", "full_ate_m", "re_trans_rmse_m", "re_rot_rmse_deg"):
                    vals = [r[kk] for r in per_seed]
                    agg[kk] = float(np.mean(vals))
                    agg[kk + "_max"] = float(np.max(vals))
                # a per-run mean, beside the per-run mean ATEs
                loop_counts = [r["loops_closed"] for r in per_seed]
                agg["loops_closed"] = float(np.mean(loop_counts))
                agg["loops_closed_max"] = int(np.max(loop_counts))
                rows.append(agg)
    print()
    print("| course | matcher | loop | loops | odom-KF ATE | opt-KF ATE | full ATE |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['course']} | {r['method']} | {'on' if r['loop'] else 'off'} | {r['loops_closed']} "
              f"| {r['odom_kf_ate_m']:.2f} m | {r['opt_kf_ate_m']:.2f} m | {r['full_ate_m']:.2f} m |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
