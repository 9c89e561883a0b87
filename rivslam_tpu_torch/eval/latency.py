"""Sequential-latency harness: the whole-sequence replay's real-time factor
(port of ``rivslam_tpu/eval/latency.py``).

    python -m rivslam_tpu_torch.eval.latency [--frames 200] [--capacity 1024]
        [--optimizer LM|GN] [--fleet B] [--host-ab] [--json OUT] [--cpu]

Times ``Engine.replay_sequence`` (preprocess -> REVE -> floor -> odometry ->
window backend for every frame) on a radar-realistic synthetic course: the
first replay captures the CUDA graphs, then the steady-state ms/frame is the
best of ``--repeats`` replays. With ``--fleet B`` it also times
``Engine.replay_fleet`` over B copies of the sequence and reports the
per-sequence throughput against the single replay.

``--host-ab`` instead measures the per-frame host driver
(``process_frame``) with loop closure on, over the validation course
(``--course``, three times its length in one session; the first third warms
up), synchronous against the asynchronous loop worker: per-frame wall-time
percentiles, the worst keyframe and loop-event frames, and the stage timers.

On the card every result carries the card's name and power limit
(``nvidia-smi``), as ``"card"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np


def _card(device) -> dict:
    """The device the numbers belong to."""
    import torch

    if device.type != "cuda":
        return {"device": "cpu"}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    return {"device": "cuda", "kind": torch.cuda.get_device_name(device), "card": smi}


def _host_ab(course: str, seed: int, json_path: str | None, device) -> int:
    """Per-frame host-driver latency, synchronous against asynchronous loop closure."""
    import torch

    from rivslam_tpu_torch import pipeline
    from rivslam_tpu_torch.core.pointcloud import RadarCloud
    from rivslam_tpu_torch.eval import validation
    from rivslam_tpu_torch.io import synthetic

    # three laps' length in one session: the first third warms every path
    # (graph captures, the first loop event's detection and solve); the
    # statistics are over the rest, where further loop events land
    params = dict(validation.COURSES[course])
    params["n_frames"] = 3 * params["n_frames"]
    seq, _ = synthetic.simulate_sequence(seed=seed, **params)
    warm = params["n_frames"] // 3
    out: dict = {**_card(device), "course": course, "frames": int(seq.num_frames)}
    print(json.dumps(out))

    for mode in ("sync", "async"):
        cfg = validation.build_course_cfg(course, "FAST_APDGICP", True)
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, async_loop=(mode == "async")))
        eng = pipeline.Engine(cfg, dtype=torch.float32, device=device)
        frame_ms: list[float] = []
        kf_flags: list[bool] = []
        loop_flags: list[bool] = []
        prev_t = None
        for i in range(seq.num_frames):
            f = seq.frame(i)
            cloud = RadarCloud.from_numpy(f["xyz"], params["capacity"], doppler=f["doppler"],
                                          intensity=f["intensity"], dtype=eng.dtype, device=device)
            t0 = prev_t if prev_t is not None else f["stamp"] - 0.1
            dts, acc, gyr, m = seq.imu_between(t0, f["stamp"], 64)
            t_start = time.perf_counter()
            o = eng.process_frame(cloud, f["stamp"], dts, acc, gyr, m, altitude=seq.baro_at(f["stamp"]))
            frame_ms.append(1e3 * (time.perf_counter() - t_start))
            kf_flags.append(bool(o["is_keyframe"]))
            loop_flags.append(bool(o["loop_found"]))
            prev_t = f["stamp"]
        eng.finalize()
        eng.close()
        g = eng.state.graph
        a = np.asarray(frame_ms[warm:])
        kf = np.asarray(kf_flags[warm:])
        lf = np.asarray(loop_flags[warm:])
        res = {
            "median_ms": float(np.median(a)),
            "p95_ms": float(np.percentile(a, 95)),
            "max_ms": float(a.max()),
            "max_keyframe_ms": float(a[kf].max()) if kf.any() else None,
            # the stall this mode exists to remove: the frame where the loop
            # event lands (sync: detection, verification and the global
            # solve inline; async: only the merge)
            "loop_event_max_ms": float(a[lf].max()) if lf.any() else None,
            "loop_events_measured": int(lf.sum()),
            "loops_closed": int(g.loop_mask.sum()) if g is not None else 0,
            "loop_detections_skipped": eng.loop_stats["skipped_worker_busy"],
        }
        # where the loop work ran: inline ("loop", "graph_opt") or on the
        # worker thread ("*_async")
        res["stages"] = {
            name: {"median_ms": s["median_ms"], "max_ms": s["max_ms"]}
            for name, s in eng.timers.summary().items()
            if name in ("frame_step", "loop", "graph_opt", "loop_detect_async", "graph_opt_async")
        }
        out[mode] = res
        print(json.dumps({mode: res}))

    if json_path:
        with open(json_path, "w") as fp:
            json.dump(out, fp, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rivslam_tpu_torch.eval.latency")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--imu-capacity", type=int, default=32)
    ap.add_argument("--optimizer", default="LM", choices=["LM", "GN"])
    ap.add_argument("--fleet", type=int, default=0, metavar="B", help="also time a B-sequence fleet replay")
    ap.add_argument("--host-ab", action="store_true",
                    help="per-frame host driver with loop closure, sync vs async loop worker")
    ap.add_argument("--course", default="cp")
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card; no fallback)")
    ap.add_argument("--cov", default="KNN", choices=("KNN", "RBF"),
                    help="covariance neighborhood method A/B (RegistrationConfig.covariance_method)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import torch

    from rivslam_tpu_torch.core.device import resolve

    device = resolve("cpu" if args.cpu else "cuda")
    if args.host_ab:
        return _host_ab(args.course, args.seed, args.json, device)

    from rivslam_tpu_torch import pipeline
    from rivslam_tpu_torch.core.config import EngineConfig
    from rivslam_tpu_torch.io import datasets, synthetic

    seq, _ = synthetic.simulate_sequence(n_frames=args.frames, seed=11, radius=10.0, capacity=args.capacity)
    stacked = datasets.stack_sequence(seq, capacity=args.capacity, imu_capacity=args.imu_capacity)
    cfg = EngineConfig()
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, optimizer=args.optimizer))
    if args.cov != "KNN":
        cfg = dataclasses.replace(cfg, registration=dataclasses.replace(cfg.registration,
                                                                       covariance_method=args.cov))
    eng = pipeline.Engine(cfg, dtype=torch.float32, seed=0, device=device)

    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        r = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, r

    first_s, _ = timed(lambda: eng.replay_sequence(stacked))
    times = []
    for _ in range(args.repeats):
        t, rep = timed(lambda: eng.replay_sequence(stacked))
        times.append(t)
    dt = min(times)
    ms_frame = 1e3 * dt / args.frames
    out = {
        **_card(device),
        "frames": args.frames,
        "capacity": args.capacity,
        "optimizer": args.optimizer,
        "covariance_method": args.cov,
        "first_replay_s": first_s,
        "ms_per_frame": ms_frame,
        "frames_per_s": args.frames / dt,
        "real_time_factor_10hz": 100.0 / ms_frame,
        "mean_solver_iterations": float(rep["solver_iterations"][1:].mean()),
    }
    print(json.dumps(out))

    if args.fleet:
        B = args.fleet
        batch = {k: np.stack([v] * B) for k, v in stacked.items()}
        fleet_first, _ = timed(lambda: eng.replay_fleet(batch))
        fdt = min(timed(lambda: eng.replay_fleet(batch))[0] for _ in range(args.repeats))
        fleet = {
            "fleet_B": B,
            "first_replay_s": fleet_first,
            "ms_per_frame_per_seq": 1e3 * fdt / args.frames / B,
            "aggregate_frames_per_s": B * args.frames / fdt,
            "scaling_vs_single": dt * B / fdt,
        }
        out["fleet"] = fleet
        print(json.dumps(fleet))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
