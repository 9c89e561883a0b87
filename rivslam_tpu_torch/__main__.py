"""Command-line entry point (port of ``rivslam_tpu/__main__.py``): the
roslaunch/bag_player replacement.

    python -m rivslam_tpu_torch --seq seq.npz --out traj.txt [--map map.pcd]
        [--preset garden] [--async-loop] [--ckpt dir] [--resume dir]
        [--capacity 1024] [--device cuda|cpu]

Replays a radar sequence (an io/datasets.RadarSequence .npz, a .rivbin
native container, or a ROS1 .bag, converted next to it) through the engine,
writes the TUM trajectory (rpg_trajectory_evaluation input), optionally the
aggregated map PCD, a checkpoint (the JAX package's format: a JAX session
resumes here and the reverse) and a visualization export, and prints the
per-stage timing table the reference exposes via `/command "time"`.

``--device-replay`` runs the whole sequence through
``Engine.replay_sequence`` (preprocess, odometry and window backend for
every frame, no loop closure): the sequential real-time-factor protocol. It
prints its frames/s on stderr and writes the TUM trajectory and, with
``--map``, the keyframe-flagged frames' clouds under their window poses; it
cannot continue a ``--resume``d session, and ``--ckpt`` and ``--viz``, which
need the keyframe state, are skipped with a message.

The flags are the JAX package's, but for three:
- ``--device cuda|cpu`` (default cuda) picks the device; there is no
  fallback from the card to the CPU;
- ``--profile DIR`` writes a torch.profiler trace of the replay
  (``DIR/trace.json``, Chrome trace format) and runs it with the Engine's
  tracer on (``eval/timing``, switched on before the Engine is built):
  ``DIR/tracer.json`` holds each frame's record, the counters' totals and
  the span records on the trace's timeline; the counters' totals are
  printed beside the trace, and the per-stage table under the timing
  table;
- ``--f64`` runs in float64, which the CUDA kernels do not take: on the card
  their float32 error is raised.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rivslam_tpu_torch")
    ap.add_argument("--seq", required=True,
                    help=".npz (rivseq), .rivbin, or ROS1 .bag sequence "
                    "(bags auto-convert to .rivseq.npz next to the file)")
    ap.add_argument("--radar-topic", default="/radar_enhanced_pcl",
                    help="bag ingest: radar topic (params.yaml:4)")
    ap.add_argument("--imu-topic", default="/vectornav/imu",
                    help="bag ingest: IMU topic (params.yaml:5)")
    ap.add_argument("--baro-topic", default="/barometer")
    ap.add_argument("--gps-topic", default="/ublox/fix")
    ap.add_argument("--out", default=None, help="output TUM trajectory file "
                    "(required unless --to-rivbin/--histogram)")
    ap.add_argument("--map", default=None, help="optional output map PCD")
    ap.add_argument("--map-utm", action="store_true",
                    help="shift map points into absolute UTM using the GPS "
                         "zero_utm origin (SaveMap req.utm parity)")
    ap.add_argument("--preset", default=None,
                    help="dataset preset (ntu4dradlm|cp|nyl|garden|mine|hugin|sjtu|long)")
    ap.add_argument("--async-loop", action="store_true",
                    help="run loop detection + the global solve on a "
                    "background thread (the reference's wall-timer "
                    "architecture); corrections merge at the next frame")
    ap.add_argument("--loop-candidates", type=int, default=None,
                    help="verify top-k scan-context candidates per keyframe in one batch (default 1)")
    ap.add_argument("--histogram", action="store_true",
                    help="print per-meter point-density histogram of the sequence "
                         "(preprocessing command_callback diagnostic) and exit")
    ap.add_argument("--ckpt", default=None, help="optional checkpoint dir to dump")
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--imu-capacity", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (default cuda; no fallback)")
    ap.add_argument("--f64", action="store_true", help="run in float64 (CPU debugging)")
    ap.add_argument("--method", default=None, help="override registration method")
    ap.add_argument("--cov-method", default=None, choices=("KNN", "RBF"),
                    help="covariance neighborhood method: KNN (reference "
                    "pipeline default) or RBF (GPU_RBF_KERNEL parity)")
    ap.add_argument("--eval-gt", default=None, help="TUM ground truth for ATE report")
    ap.add_argument("--viz", default=None, help="prefix for PLY/JSON visualization export")
    ap.add_argument("--outlier-removal", default=None,
                    help="override outlier filter: NONE|RADIUS|STATISTICAL|BILATERAL")
    ap.add_argument("--no-deskew", action="store_true")
    ap.add_argument("--no-dynamic-removal", action="store_true")
    ap.add_argument("--use-ego-vel", action="store_true",
                    help="enable the ego-velocity motion prior (enable_frontend_ego_vel)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the replay to DIR/trace.json "
                    "(Chrome trace format)")
    ap.add_argument("--to-rivbin", default=None, metavar="OUT",
                    help="convert the input .npz sequence to the native "
                    ".rivbin container and exit")
    ap.add_argument("--device-replay", action="store_true",
                    help="run the whole sequence through Engine.replay_sequence "
                    "(preprocess+odometry+window backend; no loop closure): the "
                    "sequential real-time-factor protocol")
    ap.add_argument("--compress-rivbin", action="store_true",
                    help="with --to-rivbin: write the LZ4-chunked v2 "
                    "container (decoded on the prefetch workers)")
    args = ap.parse_args(argv)
    if not args.out and not (args.to_rivbin or args.histogram):
        ap.error("--out is required unless --to-rivbin/--histogram")
    if args.device_replay and args.resume:
        ap.error("--device-replay re-runs the sequence from frame 0 and "
                 "cannot continue a --resume'd session")

    import torch

    from rivslam_tpu_torch import pipeline
    from rivslam_tpu_torch.core.config import EngineConfig
    from rivslam_tpu_torch.core.pointcloud import RadarCloud
    from rivslam_tpu_torch.eval.timing import StageTimers
    from rivslam_tpu_torch.io import checkpoint, datasets, tum

    if args.seq.endswith(".bag"):
        # ROS1 bag ingest in one command (params.yaml:4-5 topic layout):
        # convert to the rivseq container next to the bag, then replay that;
        # reconverted when the bag is newer than the conversion
        from rivslam_tpu_torch.io import rosbag1

        conv = args.seq[:-4] + ".rivseq.npz"
        if not os.path.exists(conv) or os.path.getmtime(conv) < os.path.getmtime(args.seq):
            rosbag1.convert_bag(args.seq, conv, radar_topic=args.radar_topic,
                                imu_topic=args.imu_topic, baro_topic=args.baro_topic,
                                gps_topic=args.gps_topic)
            print(f"converted {args.seq} -> {conv}")
        else:
            print(f"using cached conversion {conv}")
        args.seq = conv

    if args.to_rivbin:
        from rivslam_tpu_torch.runtime import native

        seq = datasets.RadarSequence.load(args.seq)
        native.write_rivbin(args.to_rivbin, seq, compress=args.compress_rivbin)
        v = "v2 (LZ4-chunked)" if args.compress_rivbin else "v1 (raw mmap)"
        print(f"wrote {args.to_rivbin} [{v}], {seq.num_frames} frames")
        return 0

    if args.preset:
        from rivslam_tpu_torch import presets

        cfg = presets.get(args.preset)
    else:
        cfg = EngineConfig()
    r = dataclasses.replace
    if args.cov_method:
        cfg = r(cfg, registration=r(cfg.registration, covariance_method=args.cov_method))
    if args.method:
        cfg = r(cfg, registration=r(cfg.registration, method=args.method))
    pp = cfg.preprocess
    if args.outlier_removal:
        pp = r(pp, outlier_removal_method=args.outlier_removal)
    if args.no_deskew:
        pp = r(pp, enable_deskew=False)
    if args.no_dynamic_removal:
        pp = r(pp, enable_dynamic_object_removal=False)
    cfg = r(cfg, preprocess=pp)
    if args.loop_candidates is not None:
        cfg = r(cfg, loop=r(cfg.loop, verify_candidates=args.loop_candidates))
    if args.async_loop:
        cfg = r(cfg, loop=r(cfg.loop, async_loop=True))
    if args.use_ego_vel:
        cfg = r(cfg, odometry=r(cfg.odometry, use_ego_vel=True))
    dtype = torch.float64 if args.f64 else torch.float32

    if args.histogram:
        from rivslam_tpu_torch.ops import filters

        if args.seq.endswith(".rivbin"):
            from rivslam_tpu_torch.runtime import native

            ns = native.NativeSequence(args.seq)
            n = ns.num_frames
            # slice off the fixed-capacity padding: only real targets count
            get = lambda i: ns.read_frame(i, max(args.capacity, ns.frame_count(i)))[0][: ns.frame_count(i)]
        else:
            sq = datasets.RadarSequence.load(args.seq)
            n = sq.num_frames
            get = lambda i: sq.frame(i)["xyz"]
        hist = np.zeros(100, dtype=np.int64)
        step = max(1, n // 50)
        for i in range(0, n, step):
            xyz = np.asarray(get(i), dtype=np.float64)
            cl = RadarCloud.from_numpy(xyz, max(len(xyz), args.capacity), dtype=torch.float64,
                                       device=args.device)
            hist += filters.distance_histogram(cl).cpu().numpy()
        total = hist.sum()
        print("# per-meter point density (sampled every", step, "frames)")
        for lo in range(0, 100, 10):
            cnt = int(hist[lo:lo + 10].sum())
            bar = "#" * int(60 * cnt / max(1, hist.max() * 10))
            print(f"{lo:3d}-{lo + 10:3d} m: {cnt:8d} ({100.0 * cnt / max(1, total):5.1f}%) {bar}")
        print(f"total sampled points: {total}")
        return 0

    # with --profile the tracer is on from before the Engine is built, so
    # that its graph captures are traced
    timers = StageTimers().on() if args.profile else None
    eng = pipeline.Engine(cfg, dtype=dtype, device=args.device, timers=timers)
    if args.resume:
        checkpoint.load(eng, args.resume)

    profiler = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if eng.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    if args.device_replay:
        return _device_replay(args, eng, profiler)
    with profiler if profiler is not None else contextlib.nullcontext():
        if args.seq.endswith(".rivbin"):
            from rivslam_tpu_torch.runtime import native

            ns = native.NativeSequence(args.seq)
            loader = native.PrefetchLoader(ns, capacity=args.capacity)
            while True:
                item = loader.next_aligned(args.imu_capacity)
                if item is None:
                    break
                idx, stamp, xyz, dop, inten, mask, dts, acc, gyr, m = item
                cloud = RadarCloud(*(torch.as_tensor(a, dtype=dtype).to(eng.device) for a in (xyz, dop, inten)),
                                   mask=torch.as_tensor(mask).to(eng.device))
                eng.process_frame(cloud, stamp, dts, acc, gyr, m)
                if idx % 50 == 0:
                    print(f"frame {idx}/{ns.num_frames}", file=sys.stderr)
            eng.finalize()
        else:
            seq = datasets.RadarSequence.load(args.seq)
            datasets.replay(
                eng, seq, capacity=args.capacity, imu_capacity=args.imu_capacity,
                progress=lambda i, n: print(f"frame {i}/{n}", file=sys.stderr) if i % 50 == 0 else None,
            )
    if profiler is not None:
        _write_profile(profiler, args.profile, eng.timers)

    ts, poses = eng.trajectory()
    tum.save_tum(args.out, ts, poses)
    print(f"wrote {len(ts)} poses to {args.out}")

    if args.map:
        from rivslam_tpu_torch.backend import map as map_mod

        st = eng.state
        if st.kf_clouds:
            kf_xyz = torch.stack([x for x, _ in st.kf_clouds])
            kf_mask = torch.stack([m for _, m in st.kf_clouds])
            kf_poses = torch.as_tensor(eng.optimized_keyframe_poses(), dtype=dtype, device=eng.device)
            map_xyz, valid = map_mod.assemble_map(kf_xyz, kf_mask, kf_poses)
            pts = map_xyz[valid].cpu().numpy()
            map_mod.save_map_pcd(args.map, pts, zero_utm=st.zero_utm, apply_utm_offset=args.map_utm)
            print(f"wrote {len(pts)} map points to {args.map}")

    if args.ckpt:
        checkpoint.dump(eng, args.ckpt)
        print(f"checkpoint -> {args.ckpt}")

    if args.viz:
        from rivslam_tpu_torch.eval import viz

        written = viz.export_session(eng, args.viz)
        print("viz:", ", ".join(written.values()))

    if args.eval_gt:
        _eval_gt(args, ts, poses)

    print(eng.timers.report())
    s = eng.loop_stats
    if eng.cfg.loop.enable and s["detections_run"] + s["skipped_worker_busy"] > 0:
        print(
            f"loop closure: {s['accepted']} accepted / {s['detections_run']} detections "
            f"(no-candidate {s['no_candidate']}, verify-rejected {s['rejected_verify']}, "
            f"odom-check {s['rejected_odom_check']}, pairwise {s['rejected_pairwise']}); "
            f"{s['skipped_worker_busy']} keyframes skipped (worker busy)"
        )
        if s["skipped_worker_busy"] > s["detections_run"]:
            print("WARNING: async loop worker overran on most keyframes — loop recall is "
                  "degraded; consider sync mode or a larger detection interval")
    eng.close()
    return 0


def _write_profile(profiler, path: str, timers: StageTimers) -> None:
    """The profiler's trace and, beside it, the tracer's records and
    totals (the tracer is switched off here)."""
    import json

    timers.off()
    os.makedirs(path, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(path, "trace.json"))
    with open(os.path.join(path, "tracer.json"), "w") as f:
        json.dump({"frames": timers.frames(), "totals": timers.totals(),
                   "spans": timers.profiler_spans(profiler)}, f)
    print(f"torch.profiler trace written to {path}/trace.json, the tracer's records to {path}/tracer.json",
          file=sys.stderr)
    print(f"tracer totals: {timers.totals()}", file=sys.stderr)


def _device_replay(args, eng, profiler) -> int:
    """--device-replay: the whole sequence through Engine.replay_sequence
    (no loop closure), its TUM trajectory and optionally its map."""
    import time

    import torch

    from rivslam_tpu_torch.io import datasets, tum

    if args.seq.endswith(".rivbin"):
        from rivslam_tpu_torch.runtime import native

        stacked = datasets.stack_native_sequence(native.NativeSequence(args.seq), capacity=args.capacity,
                                                 imu_capacity=args.imu_capacity)
    else:
        stacked = datasets.stack_sequence(datasets.RadarSequence.load(args.seq), capacity=args.capacity,
                                          imu_capacity=args.imu_capacity)
    with profiler if profiler is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        rep = eng.replay_sequence(stacked)
        dt = time.perf_counter() - t0
    if profiler is not None:
        _write_profile(profiler, args.profile, eng.timers)
    F = len(stacked["stamps"])
    print(f"device replay: {F} frames in {dt:.3f} s ({F / dt:.1f} frames/s, {1e3 * dt / F:.2f} ms/frame; "
          "the first replay includes the CUDA graph captures: re-run for steady-state timing)",
          file=sys.stderr)
    for t, pose in zip(stacked["stamps"], rep["pose"]):
        eng.state.trajectory.append((float(t), np.asarray(pose)))
    if args.map:
        # the MapCloudGenerator role from the replay's outputs: the
        # keyframe-flagged frames' clouds under their window-backend poses
        # (no loop correction: the replay has no loop stage)
        from rivslam_tpu_torch.backend import map as map_mod

        kf = np.asarray(rep["is_keyframe"], bool)

        def t_(a, dtype=eng.dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(eng.device)

        map_xyz, valid = map_mod.assemble_map(t_(stacked["xyz"][kf]), t_(stacked["mask"][kf], torch.bool),
                                              t_(rep["pose"][kf]))
        pts = map_xyz[valid].cpu().numpy()
        map_mod.save_map_pcd(args.map, pts, zero_utm=None, apply_utm_offset=False)
        print(f"wrote {len(pts)} map points to {args.map}")
    for flag in ("ckpt", "viz"):
        if getattr(args, flag):
            print(f"--{flag} needs keyframe state; not available under --device-replay", file=sys.stderr)
    ts, poses = eng.trajectory()
    tum.save_tum(args.out, ts, poses)
    print(f"wrote {len(ts)} poses to {args.out}")
    if args.eval_gt:
        _eval_gt(args, ts, poses)
    return 0


def _eval_gt(args, ts, poses) -> None:
    from rivslam_tpu_torch.eval import ate as ate_mod
    from rivslam_tpu_torch.io import tum

    gt_ts, gt_poses = tum.load_tum(args.eval_gt)
    pairs = tum.associate_by_stamp(ts, gt_ts, max_dt=0.05)
    if len(pairs) >= 3:
        est_p = np.stack([poses[i][:3, 3] for i, _ in pairs])
        gt_p = np.stack([gt_poses[j][:3, 3] for _, j in pairs])
        print("ATE:", ate_mod.ate(est_p, gt_p))


if __name__ == "__main__":
    raise SystemExit(main())
