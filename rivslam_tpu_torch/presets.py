"""Named per-dataset engine presets.

The PyTorch port's own copy of ``rivslam_tpu/presets.py`` (held equal to
it by the tests).

The reference selects datasets through `radar_dataset` (launch:9) which picks
the radar input callback (preprocessing_nodelet.cpp:66-80: "eagle" 4D-radar
pointclouds, "hugin" field clouds with a swapped coordinate convention, any
other name = generic PointCloud2) plus bag-specific topics. Here the format
shims live in io/ (datasets.eagle_channels_to_frame / hugin_fields_to_frame,
rosbag1.convert_bag auto-detect); a preset bundles the matching EngineConfig
knobs and the converter format string so a reference user can switch by name.

Values are the launch-file defaults (already the config defaults) with
per-dataset deltas documented inline. Capacity knobs are TPU-specific (static
shapes) and sized from the datasets' published scan densities.
"""

from __future__ import annotations

import dataclasses

from rivslam_tpu_torch.core.config import (
    EngineConfig,
    LoopConfig,
    OdometryConfig,
    PreprocessConfig,
)


def _base() -> EngineConfig:
    return EngineConfig()


def _rbf_covariances(cfg: EngineConfig) -> EngineConfig:
    """Dataset presets ship the RBF covariance mode at kernel width 4.0.

    Round-5 sweep (VALIDATION_r5_*.json: kw in {0.25,0.5,1,2,4,8,16} x 4
    courses x 3 seeds x loop on/off vs the KNN arm): RBF at kw>=4 beats the
    KNN default on full-trajectory ATE in ALL 8 (course, loop) cells — e.g.
    loop-on nyl 1.68 -> 0.38 m, garden 1.72 -> 0.58 m, cp 0.59 -> 0.31 m —
    with more loop closures and +55% registration throughput (7470 vs 4824
    fps, BENCH r5; the prepare stage drops its approx_min_k top-k pass).
    kw 4 and 8 tie at the optimum plateau (effective Gaussian neighborhood
    sigma = 1/sqrt(2 kw) ~ 0.25-0.35 m); 4.0 is the interior point and the
    best loop-off aggregate. The round-4 "mine regression" at kw=1 that
    blocked this flip was 2-seed noise (3-seed mean 0.50 vs KNN 0.48).

    The BARE RegistrationConfig keeps the reference-launch defaults (KNN,
    kw 0.25 — fast_vgicp_cuda.cu:25) for faithful A/Bs; presets are where
    this framework's own serving choices live."""
    return dataclasses.replace(
        cfg,
        registration=dataclasses.replace(
            cfg.registration, covariance_method="RBF", rbf_kernel_width=4.0
        ),
    )


def ntu4dradlm(sequence: str = "cp") -> EngineConfig:
    """NTU4DRadLM (Oculii Eagle radar, 'eagle' dataset path).

    Launch defaults apply directly; the cp/nyl handheld sequences are
    slow-moving (~1-2 m/s) while garden is a cart. Radar frames carry
    ~1000-1500 targets -> raw capacity 2048 is ample.
    """
    cfg = _rbf_covariances(_base())
    cfg = dataclasses.replace(
        cfg,
        preprocess=dataclasses.replace(
            cfg.preprocess, enable_under_floor_removal=True
        ),
    )
    if sequence in ("cp", "nyl"):
        # handheld: smaller keyframe spacing keeps the odometry chain dense
        cfg = dataclasses.replace(
            cfg,
            odometry=dataclasses.replace(cfg.odometry, keyframe_delta_trans=0.5),
        )
    if sequence in ("nyl", "garden"):
        # Documented delta from the launch default (enable_scan_to_map:
        # launch:23, default false): on the long open-loop courses the
        # scan-to-submap frontend cuts drift enough to change the outcome —
        # radar-realistic validation (eval/validation.py, 2 seeds): nyl full
        # ATE 2.48 -> 1.97 m, garden 7.45 -> 1.80 m (seed 21) with a loop
        # closure the scan-to-scan path never gets close enough to attempt.
        # cp (short dense course) is slightly *hurt* by it, so it stays off
        # there, matching the reference default.
        cfg = dataclasses.replace(
            cfg,
            odometry=dataclasses.replace(cfg.odometry, enable_scan_to_map=True),
        )
    if sequence == "garden":
        # cart platform, fastest + longest course: measured odometry drift
        # runs 6-9% of travel (validation matrix seeds 21/22), so the
        # reference's hardcoded 5%/m candidate ellipse + 20 deg yaw gate
        # reject the genuine lap-closure candidates outright. Widen the
        # drift model to match the platform and verify the top-3
        # scan-context candidates (one vmapped dispatch, BENCHMARKS.md).
        cfg = dataclasses.replace(
            cfg,
            loop=dataclasses.replace(
                cfg.loop,
                odom_drift_xy=0.15,
                max_yaw_difference_deg=40.0,
                verify_candidates=3,
            ),
        )
    return cfg


def mine_and_forest() -> EngineConfig:
    """MineAndForest (Sensrad Hugin radar, 'hugin' dataset path).

    The coordinate swap (x,y,z) <- (y,-x,z) is applied by
    io/datasets.hugin_fields_to_frame (preprocessing_nodelet.cpp:237-243);
    underground galleries have dense multipath -> keep RADIUS outlier removal
    and dynamic-object removal on, and use the frontend ego-velocity prior
    (the paper's mine runs enable it).
    """
    cfg = _rbf_covariances(_base())
    return dataclasses.replace(
        cfg,
        preprocess=dataclasses.replace(
            cfg.preprocess,
            outlier_removal_method="RADIUS",
            enable_under_floor_removal=True,
        ),
        odometry=dataclasses.replace(cfg.odometry, use_ego_vel=True),
    )


def sjtu_scan_extended() -> EngineConfig:
    """Generic msgs_radar/RadarScanExtended bags (spherical targets).

    Converted by io/rosbag1.parse_radar_scan_extended (targets_to_xyz applies
    the reference's negated-z spherical convention).
    """
    return _base()


def long_run() -> EngineConfig:
    """Multi-km sessions: larger loop graph + compaction headroom."""
    cfg = _base()
    return dataclasses.replace(
        cfg,
        loop=dataclasses.replace(
            cfg.loop, keyframe_capacity=4096, loop_capacity=64
        ),
    )


_PRESETS = {
    "ntu4dradlm": ntu4dradlm,
    "cp": lambda: ntu4dradlm("cp"),
    "nyl": lambda: ntu4dradlm("nyl"),
    "garden": lambda: ntu4dradlm("garden"),
    "mine": mine_and_forest,
    "hugin": mine_and_forest,
    "sjtu": sjtu_scan_extended,
    "long": long_run,
}


def names() -> list[str]:
    return sorted(_PRESETS)


def get(name: str) -> EngineConfig:
    """Resolve a preset by name; raises ValueError listing valid names."""
    try:
        return _PRESETS[name]()
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {', '.join(names())}"
        ) from None
