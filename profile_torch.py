"""Where the time of the port goes on the card.

    python3 profile_torch.py [--cov KNN|RBF] [--k1 on|off]
    python3 profile_torch.py --engine [--loop | --garden [--async-loop]] [--warmup 8] [--frames 4]
    python3 profile_torch.py --replay [--frames 20]
    python3 profile_torch.py --kernels [--root DIR]
    python3 profile_torch.py --digest [--root DIR]

The default mode runs bench.py's protocol (B=256 frame pairs, capacity
1024, target prepared once, identity guess) through rivslam_tpu_torch on one
CUDA device: times the source prepare and the registration by CUDA events,
then traces one batch with torch.profiler and prints the device time by
kernel, the number of kernel launches, and the device's idle share over the
traced batch.

``--engine`` runs the engine over the "cp" course of chip_smoke.py
(capacity 1024, IMU capacity 64; loop closure off, as chip_smoke.py's
card-vs-CPU check, or with ``--loop`` the "cp" preset as shipped, loop
closure on; with ``--garden`` the "garden" course under chip_smoke.py's
garden-course configuration, scan-to-map odometry and loop closure on, the
loop worker asynchronous with ``--async-loop``), lets ``--warmup`` frames
pass, then traces each of the next
``--frames`` frames of ``process_frame`` on its own and prints per frame:
wall time, the host time of each stage (the Engine's ``record_function``
scopes, the keyframe graph's among them: ``engine.keyframe``,
``engine.loop_detection``, ``engine.global_solve``; the scan-to-map
registration's ``odometry.scan_to_map`` and ``odometry.submap``; with
``--async-loop`` the trace holds the frame's thread only, the loop worker's
times are the Engine's ``loop_detect_async`` and ``graph_opt_async``
timers), the kernels run on the
device, split into those the host launched one by one and those of the
CUDA graph replays (and K1/K2/K3 launches), whether a loop closed, device busy ms, idle share and
the top device operations. Kernel counts include the launches inside graph
replays (the backend's and the odometry registration's); the registration's
host reads (one per outer LM iteration) are counted too. On the cp course
the first loop candidates come
after ~100 frames (50 m of travel), so ``--loop --warmup 100 --frames 20``
traces the loop closure.

``--replay`` traces ``Engine.replay_sequence`` over the cp course's first
``--frames`` frames (loop closure off, K1 on), after a replay that captures
the CUDA graphs: wall and device busy time, the device's idle share, kernels
on the device and launched by the host, graph replays, registration host
reads and host ms by stage, per frame.

``--kernels`` times K1, K2 and K3 through the port's public wrappers on
seeded inputs: B=256 random clouds (every target valid, F = 9 and 12; 90%
valid, F = 9) by CUDA events, and the engine's shape (B=1, N=M=1024, 30%
valid, F = 12) as device time in a CUDA graph. ``--digest`` runs the engine
configurations of chip_smoke.py phases 9-10 (the cp preset for engine seeds
0, 1 and 2, the exact path for seed 0) and the garden preset as shipped
over the garden course, prints the sha256 of each run's corrected and
uncorrected trajectories, as chip_smoke.py does, and holds each run's ATE
to 1.5x the JAX engine's for its seed (chip_smoke.py's REF; cp seeds 1 and
2 and the shipped garden preset are held here only); each cp run's
per-frame position gap to the JAX engine's run of the same seed
(chip_smoke.jax_gap) is printed, and held to chip_smoke.max_gap_m for this
checkout; ``--seeds S...`` runs other cp seeds (a seed without a JAX
figure is printed, not held), ``--nudge up|down`` the cp course with every
point moved one float32 ulp (printed, not held: the card's own rounding
spread). With ``--root DIR`` both import the port from the checkout at DIR
instead of this one: run two checkouts in one call, in turns (a, b, b, a),
to compare them on one card.

The last line is one JSON object with these numbers. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

B, CAPACITY = 256, 1024
DIGEST_SEEDS = (0, 1, 2)  # --digest: the cp preset's engine seeds


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cov", choices=("KNN", "RBF"), default="KNN")
    ap.add_argument("--k1", choices=("on", "off"), default="on")
    ap.add_argument("--engine", action="store_true", help="profile the per-frame engine")
    ap.add_argument("--replay", action="store_true", help="profile Engine.replay_sequence (--frames frames)")
    ap.add_argument("--loop", action="store_true", help="with --engine: loop closure on")
    ap.add_argument("--garden", action="store_true",
                    help="with --engine: the garden course, scan-to-map and loop closure on")
    ap.add_argument("--async-loop", action="store_true", help="with --engine --garden: the async loop worker")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--kernels", action="store_true", help="time K1-K3 through the wrappers")
    ap.add_argument("--digest", action="store_true", help="digests of the engine runs' trajectories")
    ap.add_argument("--root", help="with --kernels or --digest: import the port from this checkout")
    ap.add_argument("--seeds", type=int, nargs="+", default=DIGEST_SEEDS,
                    help="with --digest: the cp preset's engine seeds (those without a JAX figure are not held)")
    ap.add_argument("--nudge", choices=("up", "down"),
                    help="with --digest: move every cp point one float32 ulp (printed, not held)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if args.kernels:
        return time_kernels(args)
    if args.digest:
        return digest_engine(args)
    if args.replay:
        return profile_replay(args)
    if args.engine:
        return profile_engine(args)
    from rivslam_tpu_torch.core.config import RegistrationConfig
    from rivslam_tpu_torch.frontend import apdgicp
    from rivslam_tpu_torch.io import synthetic

    smi = _smi()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        RegistrationConfig(), covariance_method=args.cov,
        use_pallas_correspondence=args.k1 == "on",
    )
    src_xyz, src_mask, tgt_xyz, tgt_mask, _ = synthetic.load_pairs(B, CAPACITY, device=dev)
    guess = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
    tgt = apdgicp.prepare(tgt_xyz, tgt_mask, cfg, device=dev)

    def prepare():
        return apdgicp.prepare(src_xyz, src_mask, cfg, device=dev)

    def register(src):
        return apdgicp.register_dispatch(src, tgt, guess, cfg, device=dev)

    register(prepare())  # warm-up: kernel build, allocator, cuBLAS handles
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    stage_ms = {"prepare": [], "register": []}
    for _ in range(3):
        ev[0].record()
        src = prepare()
        ev[1].record()
        res = register(src)
        ev[2].record()
        ev[2].synchronize()
        stage_ms["prepare"].append(ev[0].elapsed_time(ev[1]))
        stage_ms["register"].append(ev[1].elapsed_time(ev[2]))
    stage_ms = {k: sorted(v)[1] for k, v in stage_ms.items()}  # median of 3

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = register(prepare())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, device_ms, by_name = _device_kernels(prof)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    print(f"{smi}; cov={args.cov} K1={args.k1}; B={B}, capacity={CAPACITY}; "
          f"outer iterations: mean {res.iterations.float().mean().item():.2f}, "
          f"max {int(res.iterations.max())}", flush=True)
    print(f"stage times (CUDA events, median of 3): prepare {stage_ms['prepare']:.3f} ms, "
          f"register {stage_ms['register']:.3f} ms", flush=True)
    print(f"traced batch: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms, "
          f"{len(kernels)} kernel launches, idle share {1 - device_ms / wall_ms:.3f}", flush=True)
    for name, times in top:
        print(f"  {sum(times):9.3f} ms  {len(times):5d}x  {name[:110]}", flush=True)
    print(json.dumps({
        "card": smi, "cov": args.cov, "k1": args.k1,
        "frames_per_s": B / ((stage_ms["prepare"] + stage_ms["register"]) / 1e3),
        "prepare_ms": stage_ms["prepare"], "register_ms": stage_ms["register"],
        "traced_wall_ms": wall_ms, "device_busy_ms": device_ms,
        "idle_share": 1 - device_ms / wall_ms, "kernel_launches": len(kernels),
        "top": [[n[:80], sum(t), len(t)] for n, t in top[:8]],
    }), flush=True)


def _device_kernels(prof):
    """(kernel events, device busy ms, {name: [ms, ...]}) of a trace. The
    Engine's stage scopes can appear on the device timeline as annotations
    spanning their kernels; they are not kernels."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in STAGES]
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
    return kernels, sum(e.device_time_total for e in kernels) / 1e3, by_name


def _host_side(prof):
    """(host ms by Engine stage scope, kernels launched by the host, CUDA
    graph launches) of a trace."""
    stage_ms = {k: 0.0 for k in STAGES}
    host_launches = graph_launches = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name in stage_ms:
            stage_ms[e.name] += e.cpu_time_total / 1e3
        elif e.name.startswith("cudaLaunchKernel") or e.name.startswith("cuLaunchKernel"):
            host_launches += 1
        elif e.name.startswith("cudaGraphLaunch"):
            graph_launches += 1
    return stage_ms, host_launches, graph_launches


def profile_replay(args) -> None:
    """The whole-sequence replay traced: a replay of the cp course's first
    ``--frames`` frames (loop closure off, K1 on) after one that captures
    the graphs; per-frame means and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import COURSE, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, ENGINE_SEED, frames, loop_off_cfg
    from rivslam_tpu_torch import pipeline, presets
    from rivslam_tpu_torch.io import datasets, synthetic

    smi = _smi()
    seq, _ = synthetic.simulate_sequence(**COURSE)
    F = min(args.frames, seq.num_frames)
    stacked = datasets.stack_sequence(frames(seq, 0, F), ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
    eng = pipeline.Engine(loop_off_cfg(presets), seed=ENGINE_SEED, device="cuda")
    eng.replay_sequence(stacked)  # the graph captures
    reads0 = eng.reg_graphs.reads
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.replay_sequence(stacked)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy, by_name = _device_kernels(prof)
    stage_ms, host_launches, graph_launches = _host_side(prof)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    reads = eng.reg_graphs.reads - reads0
    print(f"{smi}; replay of the cp course's first {F} frames (loop closure off, capacity {ENGINE_CAPACITY}), "
          f"traced: wall {wall_ms:.3f} ms ({wall_ms / F:.3f} ms a frame), device busy {busy:.3f} ms, idle "
          f"share {1 - busy / wall_ms:.3f}; {len(kernels)} kernels on the device ({len(kernels) / F:.0f} a "
          f"frame), {host_launches / F:.0f} launched by the host a frame, {graph_launches / F:.2f} graph "
          f"replays a frame; registration host reads {reads / F:.2f} a frame, window iterations "
          f"{rep['solver_iterations'].mean():.2f} a frame", flush=True)
    print("  host ms a frame by stage: " + ", ".join(f"{k} {v / F:.1f}" for k, v in stage_ms.items() if v),
          flush=True)
    for name, times in top:
        print(f"  {sum(times):9.3f} ms  {len(times):5d}x  {name[:110]}", flush=True)
    print(json.dumps({"card": smi, "mode": "replay", "frames": F, "wall_ms": wall_ms, "device_busy_ms": busy,
                      "idle_share": 1 - busy / wall_ms, "kernels": len(kernels), "host_launches": host_launches,
                      "graph_launches": graph_launches, "registration_host_reads": reads,
                      "stage_ms": stage_ms}), flush=True)


STAGES = ("engine.preprocess", "engine.odometry", "odometry.scan_to_map", "odometry.submap",
          "engine.backend", "backend.preintegrate", "backend.information", "backend.window_solve",
          "engine.keyframe", "engine.loop_detection", "engine.global_solve")


def profile_engine(args) -> None:
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (COURSE, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, ENGINE_SEED, GARDEN_COURSE,
                            frames, garden_course_cfg, loop_off_cfg, preset_cfg)
    from rivslam_tpu_torch import pipeline, presets
    from rivslam_tpu_torch.io import datasets, synthetic
    from rivslam_tpu_torch.ops import nn_argmin, nn_corr, nn_gather

    counted = {"K1": nn_gather.fused_gather, "K2": nn_corr.fused_correspondence,
               "K3": nn_argmin.nearest_neighbor}

    smi = _smi()
    # the first frames of chip_smoke.py's course: simulated at its full
    # length (its IMU noise stream depends on the frame count), then cut
    seq, _ = synthetic.simulate_sequence(**(GARDEN_COURSE if args.garden else COURSE))
    seq = frames(seq, 0, min(args.warmup + args.frames, seq.num_frames))
    if args.garden:
        cfg = garden_course_cfg()
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, async_loop=args.async_loop))
    else:
        cfg = (preset_cfg if args.loop else loop_off_cfg)(presets)
    eng = pipeline.Engine(cfg, seed=ENGINE_SEED, device="cuda")
    state = {"prof": None, "t0": 0.0, "k": {}, "loops": 0, "reads": 0}
    rows = []

    def start():
        state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        state["k"] = {name: fn.launches for name, fn in counted.items()}
        state["loops"] = eng.loop_stats["accepted"]
        state["reads"] = eng.reg_graphs.reads
        state["prof"].start()
        state["t0"] = time.perf_counter()

    def tick(i, n):  # called by replay after each frame (process_frame has synced)
        if state["prof"] is not None:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - state["t0"]) * 1e3
            state["prof"].stop()
            kernels, busy, by_name = _device_kernels(state["prof"])
            top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
            stage_ms, host_launches, graph_launches = _host_side(state["prof"])
            rows.append({
                "frame": i, "wall_ms": wall_ms, "kernel_launches": len(kernels),
                "host_kernel_launches": host_launches, "graph_launches": graph_launches,
                **{f"{name.lower()}_launches": fn.launches - state["k"][name]
                   for name, fn in counted.items()},
                "registration_host_reads": eng.reg_graphs.reads - state["reads"],
                "loop_closed": eng.loop_stats["accepted"] > state["loops"],
                "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms, "stage_ms": stage_ms,
                "top": [[name[:80], sum(t), len(t)] for name, t in top],
            })
            state["prof"] = None
        if args.warmup - 1 <= i < n - 1:
            start()

    datasets.replay(eng, seq, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, progress=tick)
    course = f"garden course{', async loop worker' if args.async_loop else ''}" if args.garden else "cp course"
    print(f"{smi}; engine, {course}, loop closure {'on' if args.loop or args.garden else 'off'}, capacity "
          f"{ENGINE_CAPACITY}; frames {args.warmup}..{args.warmup + args.frames - 1} traced one "
          f"by one; loop_stats {json.dumps(eng.loop_stats)}", flush=True)
    for r in rows:
        print(f"frame {r['frame']}: wall {r['wall_ms']:.3f} ms, {r['kernel_launches']} kernels on "
              f"the device, of them {r['host_kernel_launches']} launched by the host and the rest "
              f"by {r['graph_launches']} graph replays (K1 {r['k1_launches']}, K2 "
              f"{r['k2_launches']}, K3 {r['k3_launches']}; registration host reads "
              f"{r['registration_host_reads']}), "
              f"device busy {r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}"
              f"{', loop closed' if r['loop_closed'] else ''}", flush=True)
        print("  host ms by stage: " + ", ".join(
            f"{k} {v:.1f}" for k, v in r["stage_ms"].items())
            + f"; the window solve is {r['stage_ms']['backend.window_solve'] / r['wall_ms']:.1%} "
            "of the frame", flush=True)
        for name, ms, n in r["top"]:
            print(f"  {ms:9.3f} ms  {n:5d}x  {name}", flush=True)
    print(json.dumps({"card": smi, "mode": "engine", "loop": args.loop,
                      "loop_stats": eng.loop_stats, "frames": rows}), flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def time_kernels(args) -> None:
    import numpy as np

    import rivslam_tpu_torch
    from rivslam_tpu_torch.ops import nn_argmin, nn_corr, nn_gather

    root = os.path.dirname(rivslam_tpu_torch.__file__)
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)

    def ms(fn, reps, graph):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn()
            g.replay()
            torch.cuda.synchronize()
            a.record()
            g.replay()
        else:
            a.record()
            for _ in range(reps):
                fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    rows = []
    for B, keep, F in ((256, 1.0, 9), (256, 1.0, 12), (256, 0.9, 9), (1, 0.3, 12)):
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
        q, r = t(rng.normal(size=(B, 1024, 3)) * 10), t(rng.normal(size=(B, 1024, 3)) * 10)
        m = t(rng.uniform(size=(B, 1024)) < keep, torch.bool)
        f = t(rng.normal(size=(B, 1024, F)))
        f_t = f.transpose(1, 2).contiguous()
        graph, reps = B == 1, (200 if B == 1 else 20)
        row = {"B": B, "valid": keep, "F": F}
        for name, fn in (("K1", lambda: nn_gather.fused_gather(q, r, m, f_t)),
                         ("K2", lambda: nn_corr.fused_correspondence(q, r, m, f)),
                         ("K3", lambda: nn_argmin.nearest_neighbor(q, r, m))):
            row[name] = [ms(fn, reps, graph) for _ in range(2)]
        rows.append(row)
        print(f"{_smi()}; port at {root}; B={B}, N=M=1024, {keep:.0%} valid, F={F}"
              f"{', device time in a CUDA graph' if graph else ''}: "
              + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in row.items() if k[0] == "K"),
              flush=True)
    print(json.dumps({"card": _smi(), "mode": "kernels", "port": root, "rows": rows}), flush=True)


def digest_engine(args) -> None:
    import hashlib

    import numpy as np

    import rivslam_tpu_torch
    from chip_smoke import (COURSE, CPU_GAP_M, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, GARDEN_COURSE, JAX_RUNS,
                            MAX_ATE_RATIO, REF, exact_cfg, garden_cfg, jax_gap, jax_run_name, max_gap_m,
                            nudged, preset_cfg)
    from rivslam_tpu_torch import pipeline, presets
    from rivslam_tpu_torch.eval import ate
    from rivslam_tpu_torch.io import datasets, synthetic

    root = os.path.dirname(rivslam_tpu_torch.__file__)
    jax_runs = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), JAX_RUNS))
    courses = {}
    for name, params in (("cp", COURSE), ("garden", GARDEN_COURSE)):
        seq, _ = synthetic.simulate_sequence(**params)
        if name == "cp":
            seq = nudged(seq, args.nudge)
        courses[name] = (seq, np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses)
    out, ates, gaps = {}, {}, {}
    for key, cfg, seeds, course in (("preset", preset_cfg(presets), args.seeds, "cp"),
                                    ("exact", exact_cfg(), (0,), "cp"),
                                    ("garden", garden_cfg(presets), (0,), "garden")):
        seq, gt = courses[course]
        for seed in seeds:
            eng = pipeline.Engine(cfg, seed=seed, device="cuda")
            outs = datasets.replay(eng, seq, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
            h, run, positions = hashlib.sha256(), f"{key} seed {seed}", {}
            for corrected in (True, False):
                ts, poses = eng.trajectory(corrected=corrected)
                h.update(np.ascontiguousarray(poses).tobytes())
                positions["corrected" if corrected else "uncorrected"] = poses[:, :3, 3]
                g = gt[[int(np.argmin(np.abs(seq.gt_stamps - t))) for t in ts]]
                ates[f"{run} {'corrected' if corrected else 'uncorrected'}"] = ate.ate(
                    poses[:, :3, 3], g[:, :3, 3])["rmse"]
            out[run] = h.hexdigest()[:16]
            ref = None if args.nudge and course == "cp" else REF[key].get(seed)
            print(f"port at {root}: engine {run}: sha256 of the corrected and uncorrected "
                  f"trajectories {out[run]}; ATE {ates[run + ' corrected']:.4f} / "
                  f"{ates[run + ' uncorrected']:.4f} m"
                  + (f" (JAX engine on the CPU: {ref['ate_m']:.4f} / {ref['uncorrected_ate_m']:.4f} m)" if ref else "")
                  + f", keyframes {sum(o['is_keyframe'] for o in outs)}, loops {eng.loop_stats['accepted']}",
                  flush=True)
            if ref is None:
                continue
            name, _ = jax_run_name(key, seed)
            if key in CPU_GAP_M:
                gaps[run] = jax_gap(jax_runs, name, positions, [o["is_keyframe"] for o in outs],
                                    [i for i, o in enumerate(outs) if o["loop_found"]],
                                    [-1 if o["status"] is None else o["status"]["num_correspondences"]
                                     for o in outs])
                print(f"port at {root}: engine {run} against the JAX engine's run {name}, per-frame position "
                      f"gap {json.dumps(gaps[run])}; limit {max_gap_m(key):.4f} m", flush=True)
            if (ates[run + " corrected"] > MAX_ATE_RATIO * ref["ate_m"]
                    or ates[run + " uncorrected"] > MAX_ATE_RATIO * ref["uncorrected_ate_m"]):
                raise SystemExit(f"engine {run}: ATE beyond {MAX_ATE_RATIO}x the JAX engine's")
            if run in gaps and args.root is None and max(gaps[run][t]["max_m"] for t in positions) > max_gap_m(key):
                raise SystemExit(f"engine {run}: positions beyond {max_gap_m(key)} m of the JAX run's")
    print(json.dumps({"card": _smi(), "mode": "digest", "port": root, "digests": out, "ate_m": ates,
                      "jax_gap": gaps}), flush=True)


if __name__ == "__main__":
    main()
