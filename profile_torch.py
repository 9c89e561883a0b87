"""Where the time of the port goes on the card.

    python3 profile_torch.py [--cov KNN|RBF] [--k1 on|off]
    python3 profile_torch.py --engine [--warmup 8] [--frames 4]

The default mode runs bench.py's protocol (B=256 frame pairs, capacity
1024, target prepared once, identity guess) through rivslam_tpu_torch on one
CUDA device: times the source prepare and the registration by CUDA events,
then traces one batch with torch.profiler and prints the device time by
kernel, the number of kernel launches, and the device's idle share over the
traced batch.

``--engine`` runs the per-frame engine over the "cp" course of
chip_smoke.py (its configuration, capacity 1024, IMU capacity 64), lets
``--warmup`` frames pass, then traces each of the next ``--frames`` frames of
``process_frame`` on its own and prints per frame: wall time, the host time
of each stage (the Engine's ``record_function`` scopes), kernel launches
(and K1/K3 launches), device busy ms, idle share and the top device
operations.

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cov", choices=("KNN", "RBF"), default="KNN")
    ap.add_argument("--k1", choices=("on", "off"), default="on")
    ap.add_argument("--engine", action="store_true", help="profile the per-frame engine")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.engine:
        return profile_engine(args)
    from rivslam_tpu_torch.core.config import RegistrationConfig
    from rivslam_tpu_torch.frontend import apdgicp
    from rivslam_tpu_torch.io import synthetic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
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


STAGES = ("engine.preprocess", "engine.odometry", "engine.backend", "backend.preintegrate",
          "backend.information", "backend.window_solve")


def profile_engine(args) -> None:
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import COURSE, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, ENGINE_SEED, engine_cfg
    from rivslam_tpu_torch import pipeline, presets
    from rivslam_tpu_torch.io import datasets, synthetic
    from rivslam_tpu_torch.ops import nn_argmin, nn_gather

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    seq, _ = synthetic.simulate_sequence(**dict(COURSE, n_frames=args.warmup + args.frames))
    eng = pipeline.Engine(engine_cfg(presets), seed=ENGINE_SEED, device="cuda")
    state = {"prof": None, "t0": 0.0, "k": (0, 0)}
    rows = []

    def start():
        state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        state["k"] = (nn_gather.fused_gather.launches, nn_argmin.nearest_neighbor.launches)
        state["prof"].start()
        state["t0"] = time.perf_counter()

    def tick(i, n):  # called by replay after each frame (process_frame has synced)
        if state["prof"] is not None:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - state["t0"]) * 1e3
            state["prof"].stop()
            kernels, busy, by_name = _device_kernels(state["prof"])
            top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
            stage_ms = {k: 0.0 for k in STAGES}
            for e in state["prof"].events():
                if e.name in stage_ms and e.device_type == torch.autograd.DeviceType.CPU:
                    stage_ms[e.name] += e.cpu_time_total / 1e3
            rows.append({
                "frame": i, "wall_ms": wall_ms, "kernel_launches": len(kernels),
                "k1_launches": nn_gather.fused_gather.launches - state["k"][0],
                "k3_launches": nn_argmin.nearest_neighbor.launches - state["k"][1],
                "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms, "stage_ms": stage_ms,
                "top": [[name[:80], sum(t), len(t)] for name, t in top],
            })
            state["prof"] = None
        if args.warmup - 1 <= i < n - 1:
            start()

    datasets.replay(eng, seq, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, progress=tick)
    print(f"{smi}; engine, cp course, capacity {ENGINE_CAPACITY}; frames "
          f"{args.warmup}..{args.warmup + args.frames - 1} traced one by one", flush=True)
    for r in rows:
        print(f"frame {r['frame']}: wall {r['wall_ms']:.3f} ms, {r['kernel_launches']} kernel "
              f"launches (K1 {r['k1_launches']}, K3 {r['k3_launches']}), device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}", flush=True)
        print("  host ms by stage: " + ", ".join(
            f"{k} {v:.1f}" for k, v in r["stage_ms"].items()), flush=True)
        for name, ms, n in r["top"]:
            print(f"  {ms:9.3f} ms  {n:5d}x  {name}", flush=True)
    print(json.dumps({"card": smi, "mode": "engine", "frames": rows}), flush=True)


if __name__ == "__main__":
    main()
