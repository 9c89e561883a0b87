"""Drive the PyTorch/CUDA port (rivslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced by a flushed "== phase" line:
  1. device   the card's name and power limit (nvidia-smi) and device count;
  2. build    K1 (csrc/nn_gather.cu) and K3 (csrc/nn_argmin.cu), one nvcc
              each, started together; wall times and ptxas reports;
  3. data     bench.py's protocol: B=256 frame pairs, capacity N=M=1024,
              from the port's numpy copy of the simulator;
  4. K1       the kernel against its plain twin on the card, on the main
              path's inputs and on ragged, fully masked and exact-tie cases;
  5. main     prepare (KNN, then RBF) + register_dispatch with the fused
              correspondence kernel on, launch counts read around the run;
              convergence and per-pair error against the ground truth, the
              flag-off path and a small input against the CPU run;
  6. timing   CUDA-event times: frames/s with the kernel on and off, K1 per
              launch beside its plain twin, the flag-off correspondence step
              (library_ms) and the least time the card could take (bound_ms);
  7. engine   the per-frame SLAM engine (Engine + replay) over the "cp"
              validation course at full width (capacity 1024, IMU capacity
              64, window 6), launch counts read around the run: ATE against
              the simulator's ground truth (held to 1.5x the JAX engine's),
              keyframes, converged share, per-frame latency, frames/s, peak
              memory; then its first 8 frames on the card against the CPU;
  8. K3       the kernel against its plain twin on the card: the engine's
              fitness inputs, B=256, ragged, masked and exact-tie cases;
  9. K3 time  per launch at the engine's shape and at B=256, the plain twin,
              the bmm + masked argmin composition, and the bound.

Any failed check raises, and the script then exits non-zero without a
result. The line before the last is a JSON object listing the kernels; the
last line is {"ok": true, "device": {...}}. It needs a CUDA device and the
repository beside it: there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B, CAPACITY = 256, 1024  # bench.py:50-53
H100_F32_OPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3, H100 SXM data sheet
D2_RTOL, D2_ATOL = 1e-4, 1e-6  # d2: relative, with a floor for d2 near 0
G_ATOL = 1e-5  # gathered features (exact ties are means of a few values)
MIN_CONVERGED = 0.9
MAX_MEDIAN_TERR_M = 0.1
# the engine phase: the "cp" validation course (rivslam_tpu/eval/validation.py:42)
COURSE = dict(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=120, capacity=1024,
              world_points=20000, extent=30.0)
ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, ENGINE_SEED = 1024, 64, 0
# full-trajectory ATE of the JAX engine on this course, configuration and
# seeds, float32 on the CPU (`python tests/test_torch_engine.py`)
REF_ATE_M = 0.7365842276827688
MAX_ATE_RATIO = 1.5
CPU_FRAMES = 8
# card vs CPU on the first frames: float32 rounding of the isolated points'
# covariances moves poses by cm (tests/test_torch_engine.py), so the gap is
# held to twice the CPU's own float32-vs-float64 gap, plus 2 cm
CPU_BAND_FACTOR, CPU_BAND_FLOOR_M = 2.0, 0.02


def phase(name: str) -> None:
    """Close the previous phase (a device fault surfaces here, where it
    happened) and announce the next one."""
    torch.cuda.synchronize()
    print(f"== {name}", flush=True)


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_k1(name, nn_gather, q, r, m, f):
    """K1 against its plain twin on the same inputs; returns the max abs error."""
    d2, g = nn_gather.fused_gather(q, r, m, f)
    pd2, pg = nn_gather.fused_gather_plain(q, r, m, f)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(g).all()), f"K1 {name}: non-finite features")
    d2_err = (d2 - pd2).abs()
    check(bool((d2_err <= D2_RTOL * pd2.abs() + D2_ATOL).all()),
          f"K1 {name}: d2 differs from the plain twin by up to {d2_err.max().item()}")
    g_err = (g - pg).abs().max().item() if g.numel() else 0.0
    check(g_err <= G_ATOL, f"K1 {name}: features differ by {g_err} > {G_ATOL}")
    err = max(d2_err.max().item(), g_err)
    say(f"K1 {name}: B,N,M,F={tuple(q.shape[:2]) + (r.shape[1], f.shape[1])} "
        f"max|d2-plain|={d2_err.max().item():.3e} max|g-plain|={g_err:.3e}")
    return err, d2, g


def k1_cases(nn_gather, dev):
    """Ragged sizes, fully masked targets and injected exact ties."""
    rng = np.random.default_rng(7)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)

    # ragged: N, M not multiples of the 128-query block or the target tiles
    q = t(rng.normal(size=(3, 1000, 3)) * 10)
    r = t(rng.normal(size=(3, 1500, 3)) * 10)
    m = t(rng.uniform(size=(3, 1500)) > 0.15, torch.bool)
    f = t(rng.normal(size=(3, 9, 1500)))
    errs = [compare_k1("ragged", nn_gather, q, r, m, f)[0]]

    # fully masked target in problem 0, partly masked in problem 1
    m = t(np.stack([np.zeros(1500, bool), rng.uniform(size=1500) > 0.5, np.ones(1500, bool)]),
          torch.bool)
    err, d2, g = compare_k1("masked", nn_gather, q, r, m, f)
    check(bool((d2[0] >= 1e30).all()) and bool((g[0] == 0).all()),
          "K1 masked: a problem without valid targets must give d2 >= 1e30, zero features")
    errs.append(err)

    # exact ties: targets 1024..1279 copy targets 0..255 (across the 512 and
    # 1024 tiles), 600..649 copy 0..49; queries 0..255 sit on targets 0..255
    rr = rng.normal(size=(2, 1536, 3)) * 10
    rr[:, 1024:1280] = rr[:, :256]
    rr[:, 600:650] = rr[:, :50]
    qq = rng.normal(size=(2, 700, 3)) * 10
    qq[:, :256] = rr[:, :256]
    ff = rng.normal(size=(2, 9, 1536))
    r, q, f = t(rr), t(qq), t(ff)
    m = torch.ones((2, 1536), dtype=torch.bool, device=dev)
    err, d2, g = compare_k1("ties", nn_gather, q, r, m, f)
    f32 = ff.astype(np.float32)
    want = (f32[:, :, 50:256] + f32[:, :, 1074:1280]) / np.float32(2)
    got = g[:, :, 50:256].cpu().numpy()
    check(np.abs(got - want).max() <= G_ATOL, "K1 ties: two-way ties are not averaged")
    errs.append(err)
    return max(errs)


def compare_k3(name, nn_argmin, q, r, m):
    """K3 against its plain twin: d2 bitwise, idx equal. Returns max|d2 err|."""
    idx, d2 = nn_argmin.nearest_neighbor(q, r, m)
    pidx, pd2 = nn_argmin.nearest_neighbor_plain(q, r, m)
    torch.cuda.synchronize()
    err = (d2 - pd2).abs().max().item()
    check(err == 0.0, f"K3 {name}: d2 differs from the plain twin by {err}")
    check(bool(torch.equal(idx, pidx)), f"K3 {name}: idx differs from the plain twin "
          f"at {int((idx != pidx).sum())} queries")
    say(f"K3 {name}: B,N,M={tuple(q.shape[:2]) + (r.shape[1],)} max|d2-plain|={err:.3e}, idx equal")
    return err, idx, d2


def k3_cases(nn_argmin, dev):
    """B=256 at full width, ragged sizes, masked refs and injected exact ties."""
    rng = np.random.default_rng(8)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    errs = []
    q, r = t(rng.normal(size=(256, 1024, 3)) * 10), t(rng.normal(size=(256, 1024, 3)) * 10)
    errs.append(compare_k3("B=256", nn_argmin, q, r, t(rng.uniform(size=(256, 1024)) > 0.1, torch.bool))[0])
    q, r = t(rng.normal(size=(3, 1000, 3)) * 10), t(rng.normal(size=(3, 1500, 3)) * 10)
    errs.append(compare_k3("ragged", nn_argmin, q, r, t(rng.uniform(size=(3, 1500)) > 0.15, torch.bool))[0])
    m = t(np.stack([np.zeros(1500, bool), rng.uniform(size=1500) > 0.5, np.ones(1500, bool)]), torch.bool)
    err, idx, d2 = compare_k3("masked", nn_argmin, q, r, m)
    check(bool((d2[0] == 1e30).all()) and bool((idx[0] == 0).all()),
          "K3 masked: a problem without valid refs must give d2 1e30 and idx 0")
    check(bool(m[1][idx[1].long()].all()), "K3 masked: a masked ref won")
    errs.append(err)
    # exact ties: refs 512..767 copy refs 0..255 (across the 512-ref tile),
    # 300..349 copy 0..49; queries 0..255 sit on refs 0..255: the first wins
    rr = rng.normal(size=(2, 1100, 3)) * 10
    rr[:, 512:768] = rr[:, :256]
    rr[:, 300:350] = rr[:, :50]
    qq = rng.normal(size=(2, 700, 3)) * 10
    qq[:, :256] = rr[:, :256]
    err, idx, _ = compare_k3("ties", nn_argmin, t(qq), t(rr), torch.ones((2, 1100), dtype=torch.bool, device=dev))
    check(bool((idx[:, :256] == torch.arange(256, device=dev)).all()), "K3 ties: the first index must win")
    errs.append(err)
    return max(errs)


def engine_cfg(presets):
    """The slice's configuration: the "cp" preset, loop closure off, K1 on."""
    cfg = presets.get("cp")
    return dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, enable=False),
        registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )


def run_main(apdgicp, cfg, data, guess, dev):
    src_xyz, src_mask, tgt_xyz, tgt_mask = data
    tgt = apdgicp.prepare(tgt_xyz, tgt_mask, cfg, device=dev)
    src = apdgicp.prepare(src_xyz, src_mask, cfg, device=dev)
    return apdgicp.register_dispatch(src, tgt, guess, cfg, device=dev)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import rivslam_tpu_torch
    from rivslam_tpu_torch.core.config import RegistrationConfig
    from rivslam_tpu_torch.core.pointcloud import SENTINEL
    from rivslam_tpu_torch.frontend import apdgicp
    from rivslam_tpu_torch import pipeline, presets
    from rivslam_tpu_torch.core import lie
    from rivslam_tpu_torch.eval import ate
    from rivslam_tpu_torch.io import datasets, synthetic
    from rivslam_tpu_torch.ops import nn_argmin, nn_gather

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind!r}, count {count}")
    card = f"[{smi}]"

    phase("2 build")
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        builds = {name: pool.submit(mod.build) for name, mod in (("K1", nn_gather), ("K3", nn_argmin))}
        builds = {name: fut.result() for name, fut in builds.items()}
    for name, built in builds.items():
        say(f"{name}: nvcc built {os.path.relpath(built.path)} in {built.seconds:.2f} s")
        for ln in built.ptxas:
            say(f"  {ln}")

    phase("3 data")
    t0 = time.perf_counter()
    *data, gt_rel = synthetic.load_pairs(B, CAPACITY, device=dev)
    src_xyz, src_mask, tgt_xyz, tgt_mask = data
    guess = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
    say(f"{B} pairs x {CAPACITY} points in {time.perf_counter() - t0:.2f} s; "
        f"valid points per cloud {src_mask.sum(1).float().mean().item():.1f}")

    phase("4 K1 against its plain twin")
    cfg_on = RegistrationConfig(use_pallas_correspondence=True)
    tgt = apdgicp.prepare(tgt_xyz, tgt_mask, cfg_on, device=dev)
    tgt_sent = torch.where(tgt.mask[..., None], tgt.xyz, SENTINEL).contiguous()
    c = tgt.cov
    feats_t = torch.stack(
        list(tgt.xyz.unbind(-1)) + [c[..., 0, 0], c[..., 0, 1], c[..., 0, 2],
                                    c[..., 1, 1], c[..., 1, 2], c[..., 2, 2]], dim=1,
    ).contiguous()
    k1_args = (src_xyz.contiguous(), tgt_sent, tgt.mask.contiguous(), feats_t)
    k1_err, _, _ = compare_k1("main-path inputs", nn_gather, *k1_args)
    k1_err = max(k1_err, k1_cases(nn_gather, dev))

    phase("5 main path")
    results, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    nn_gather.fused_gather.launches = nn_argmin.nearest_neighbor.launches = 0
    for cov in ("KNN", "RBF"):
        cfg = dataclasses.replace(cfg_on, covariance_method=cov)
        before = nn_gather.fused_gather.launches
        res = run_main(apdgicp, cfg, data, guess, dev)
        torch.cuda.synchronize()
        launches[cov] = nn_gather.fused_gather.launches - before
        results[cov] = res
    total_launches = nn_gather.fused_gather.launches
    say(f"scan-match path launches: K1 {total_launches}, K3 {nn_argmin.nearest_neighbor.launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(total_launches > 0, "the main path never launched K1")
    for cov, res in results.items():
        T = res.T.cpu().numpy()
        check(np.isfinite(T).all() and T.shape == (B, 4, 4), f"{cov}: bad T")
        conv = res.converged.float().mean().item()
        terr = np.linalg.norm(T[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
        say(f"{cov}: K1 launches {launches[cov]}, converged {conv:.4f}, "
            f"mean iterations {res.iterations.float().mean().item():.2f}, "
            f"median translation error {np.median(terr):.4f} m")
        check(launches[cov] > 0, f"{cov}: K1 not launched")
        check(conv >= MIN_CONVERGED, f"{cov}: converged {conv} < {MIN_CONVERGED}")
        check(np.median(terr) <= MAX_MEDIAN_TERR_M, f"{cov}: median error {np.median(terr)} m")
    say(f"peak device memory over the main path {peak_gib:.3f} GiB {card}")

    # the flag-off (matmul + argmin + gather) path on the same problems
    cfg_off = RegistrationConfig(use_pallas_correspondence=False)
    off = run_main(apdgicp, cfg_off, data, guess, dev)
    dT = (off.T - results["KNN"].T).abs().amax(dim=(1, 2))
    agree = (dT <= 1e-3).float().mean().item()
    same_ncorr = (off.num_correspondences == results["KNN"].num_correspondences).float().mean().item()
    say(f"flag on vs off (KNN): T within 1e-3 for {agree:.4f} of pairs, "
        f"equal correspondences for {same_ncorr:.4f}")
    check(agree >= 0.95, f"flag on and off disagree on {1 - agree:.4f} of pairs")

    # a small input on the card against the same run on the CPU
    fn, args = rivslam_tpu_torch.entry(device=dev)
    res_gpu = fn(*args)
    fn_cpu, args_cpu = rivslam_tpu_torch.entry(device="cpu")
    res_cpu = fn_cpu(*args_cpu)
    dT = (res_gpu.T.cpu() - res_cpu.T).abs().max().item()
    say(f"entry(): card vs CPU max|dT| {dT:.2e}, correspondences "
        f"{int(res_gpu.num_correspondences)} vs {int(res_cpu.num_correspondences)}")
    check(dT <= 1e-3, f"entry(): card and CPU differ by {dT}")
    check(int(res_gpu.num_correspondences) == int(res_cpu.num_correspondences),
          "entry(): correspondence counts differ")

    phase("6 timing")
    fps = {}
    for flag in (True, False):
        for cov in ("KNN", "RBF"):
            cfg = RegistrationConfig(use_pallas_correspondence=flag, covariance_method=cov)
            tgt_c = apdgicp.prepare(tgt_xyz, tgt_mask, cfg, device=dev)

            def step():
                src_c = apdgicp.prepare(src_xyz, src_mask, cfg, device=dev)
                return apdgicp.register_dispatch(src_c, tgt_c, guess, cfg, device=dev)

            ms = time_ms(step, reps=3)
            key = f"{cov} K1 {'on' if flag else 'off'}"
            fps[key] = B / (ms / 1e3)
            say(f"frames/s {key}: {fps[key]:.1f} ({ms:.3f} ms per batch of {B}) {card}")

    q, r, m, f = k1_args
    Bk, N, _ = q.shape
    M, F = r.shape[1], f.shape[1]
    k1_ms = time_ms(lambda: nn_gather.fused_gather(q, r, m, f), reps=50, warmup=3)
    plain_ms = time_ms(lambda: nn_gather.fused_gather_plain(q, r, m, f), reps=5)
    tn2 = (r * r).sum(-1)

    def library_step():  # the flag-off correspondence step at the same shapes
        cross = torch.bmm(q, r.transpose(1, 2))
        d2 = (q * q).sum(-1)[..., None] + tn2[:, None, :] - 2.0 * cross
        idx = torch.argmin(d2, dim=-1)
        best = torch.take_along_dim(d2, idx[..., None], dim=-1)
        return best, torch.gather(f, 2, idx[:, None, :].expand(-1, F, -1))

    library_ms = time_ms(library_step, reps=20, warmup=2)
    pairs = N * int(m.sum().item())  # every query against every valid target
    k1_bytes = 4 * (Bk * N * 3 + Bk * M * 3 + Bk * F * M + Bk * N + Bk * F * N) + Bk * M
    t_ops, t_bytes = 8 * pairs / H100_F32_OPS, k1_bytes / H100_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    per_batch = launches["KNN"]
    say(f"K1 {k1_ms:.4f} ms/launch, plain twin {plain_ms:.4f} ms, flag-off step "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {8 * pairs:.3e} ops, "
        f"{k1_bytes:.3e} bytes) at B,N,M,F={Bk},{N},{M},{F} {card}")
    say(f"K1 launches per batch of {B} scan matches: KNN {launches['KNN']}, RBF {launches['RBF']} "
        f"({per_batch / B:.3f} per frame)")
    k1 = {"ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": library_ms}

    phase("7 engine")
    t0 = time.perf_counter()
    seq, _ = synthetic.simulate_sequence(**COURSE)
    n_frames = seq.num_frames
    say(f"cp course: {n_frames} frames, {len(seq.imu_stamps)} IMU samples, simulated in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg_e = engine_cfg(presets)
    eng = pipeline.Engine(cfg_e, seed=ENGINE_SEED, device=dev)
    events, wall = [torch.cuda.Event(enable_timing=True)], []

    def tick(i, n):  # replay calls this after each frame; process_frame has synced
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        wall.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    nn_gather.fused_gather.launches = nn_argmin.nearest_neighbor.launches = 0
    wall.append(time.perf_counter())
    events[0].record()
    outs = datasets.replay(eng, seq, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, progress=tick)
    torch.cuda.synchronize()
    k1_eng, k3_eng = nn_gather.fused_gather.launches, nn_argmin.nearest_neighbor.launches
    engine_s = wall[-1] - wall[0]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    wall_ms = np.diff(wall) * 1e3
    ev_ms = np.array([a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])])
    ts, poses = eng.trajectory()
    check(poses.shape == (n_frames, 4, 4) and np.isfinite(poses).all(), "engine: non-finite poses")
    gt = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses
    gt = gt[[int(np.argmin(np.abs(seq.gt_stamps - t))) for t in ts]]
    full_ate = ate.ate(poses[:, :3, 3], gt[:, :3, 3])
    n_kf = sum(o["is_keyframe"] for o in outs)
    conv = float(np.mean([o["registration_ok"] for o in outs[1:]]))
    say(f"engine: {n_frames} frames in {engine_s:.2f} s = {n_frames / engine_s:.2f} frames/s; "
        f"full ATE {full_ate['rmse']:.4f} m (JAX engine on the CPU: {REF_ATE_M:.4f} m, limit "
        f"{MAX_ATE_RATIO}x); keyframes {n_kf}; converged share {conv:.4f}")
    say(f"engine launches: K1 {k1_eng} ({k1_eng / n_frames:.2f} per frame), K3 {k3_eng} "
        f"({k3_eng / n_frames:.2f} per frame)")
    for name, v in (("wall clock", wall_ms), ("CUDA events", ev_ms)):
        say(f"per-frame latency by {name} over frames 1..{n_frames - 1}: median "
            f"{np.median(v[1:]):.3f} ms, p95 {np.percentile(v[1:], 95):.3f} ms, max "
            f"{v[1:].max():.3f} ms; frame 0 {v[0]:.3f} ms {card}")
    say(f"peak device memory over the engine run {peak_gib:.3f} GiB {card}")
    check(k1_eng > 0, "the engine never launched K1")
    check(k3_eng > 0, "the engine never launched K3")
    check(full_ate["rmse"] <= MAX_ATE_RATIO * REF_ATE_M,
          f"engine ATE {full_ate['rmse']} m > {MAX_ATE_RATIO} x {REF_ATE_M} m")

    # the first frames again on the CPU, float32 and float64, same seed and
    # therefore the same RANSAC draws
    o = seq.offsets
    head = dataclasses.replace(
        seq, frame_stamps=seq.frame_stamps[:CPU_FRAMES], offsets=o[:CPU_FRAMES + 1],
        xyz=seq.xyz[:o[CPU_FRAMES]], doppler=seq.doppler[:o[CPU_FRAMES]],
        intensity=seq.intensity[:o[CPU_FRAMES]],
    )
    cpu = {}
    for dt in (torch.float32, torch.float64):
        e = pipeline.Engine(cfg_e, dtype=dt, seed=ENGINE_SEED, device="cpu")
        cpu[dt] = datasets.replay(e, head, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
    card_p = np.stack([x["pose"] for x in outs[:CPU_FRAMES]])
    cpu32, cpu64 = (np.stack([x["pose"] for x in cpu[dt]]) for dt in (torch.float32, torch.float64))
    gap, band = np.abs(card_p - cpu32).max(), np.abs(cpu32 - cpu64).max()
    same_kf = [x["is_keyframe"] for x in outs[:CPU_FRAMES]] == [x["is_keyframe"] for x in cpu[torch.float32]]
    tol = CPU_BAND_FACTOR * band + CPU_BAND_FLOOR_M
    say(f"first {CPU_FRAMES} frames, card vs CPU float32: largest pose gap {gap:.3e} "
        f"(CPU float32 vs float64: {band:.3e}; tolerance {tol:.3e}); is_keyframe flags "
        f"{'equal' if same_kf else 'differ'}")
    check(gap <= tol, f"card and CPU differ by {gap} > {tol}")

    phase("8 K3 against its plain twin")
    bk = eng.state.backend  # the last frame's fitness inputs (backend/slam.py)
    rel = lie.se3_matrix(bk.odom_R[-1].T @ bk.odom_R[-2], bk.odom_R[-1].T @ (bk.odom_p[-2] - bk.odom_p[-1]))
    q3 = lie.transform_points(rel, bk.xyz[-2])[None].contiguous()
    r3 = torch.where(bk.cloud_mask[-1][:, None], bk.xyz[-1], SENTINEL)[None].contiguous()
    m3 = bk.cloud_mask[-1][None].contiguous()
    k3_err = compare_k3("engine inputs", nn_argmin, q3, r3, m3)[0]
    k3_err = max(k3_err, k3_cases(nn_argmin, dev))

    phase("9 K3 timing")

    def k3_library(q, r, m):  # bmm + norms + masked argmin: the plain-torch composition
        d2 = (q * q).sum(-1)[..., None] + (r * r).sum(-1)[:, None, :] - 2.0 * torch.bmm(q, r.transpose(1, 2))
        d2 = torch.where(m[:, None, :], d2, torch.inf)
        idx = torch.argmin(d2, dim=-1)
        return idx, torch.take_along_dim(d2, idx[..., None], dim=-1)

    rng = np.random.default_rng(9)
    qb = torch.as_tensor(rng.normal(size=(256, 1024, 3)) * 10, dtype=torch.float32, device=dev)
    rb = torch.as_tensor(rng.normal(size=(256, 1024, 3)) * 10, dtype=torch.float32, device=dev)
    mb = torch.ones((256, 1024), dtype=torch.bool, device=dev)
    k3 = {}
    for key, (q, r, m), reps in (("engine", (q3, r3, m3), 200), ("B=256", (qb, rb, mb), 20)):
        Bq, Nq, Mq = q.shape[0], q.shape[1], r.shape[1]
        ms = time_ms(lambda: nn_argmin.nearest_neighbor(q, r, m), reps=reps, warmup=3)
        pms = time_ms(lambda: nn_argmin.nearest_neighbor_plain(q, r, m), reps=5)
        lms = time_ms(lambda: k3_library(q, r, m), reps=reps, warmup=3)
        ops = 8 * Nq * int(m.sum().item())  # every query against every valid ref
        nbytes = 4 * (Bq * Nq * 3 + Bq * Mq * 3 + 2 * Bq * Nq) + Bq * Mq
        t_ops, t_bytes = ops / H100_F32_OPS, nbytes / H100_BYTES
        k3[key] = {"ms": ms, "plain_ms": pms, "bound_ms": 1e3 * max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lms}
        say(f"K3 at {key} (B,N,M={Bq},{Nq},{Mq}): {ms:.4f} ms/launch, plain twin {pms:.4f} ms, "
            f"bmm + masked argmin {lms:.4f} ms, bound {k3[key]['bound_ms']:.5f} ms "
            f"({k3[key]['bound_by']}: {ops:.3e} ops, {nbytes:.3e} bytes) {card}")
    say(f"K3 launches per frame on the engine: {k3_eng / n_frames:.3f}")
    torch.cuda.synchronize()
    say(f"wall time {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "K1 fused_gather", "route": "cuda", "source": "rivslam_tpu_torch/csrc/nn_gather.cu",
         "replaces": "rivslam_tpu/ops/pallas_nn.py:179", "launches": k1_eng,
         "max_abs_err": k1_err, **k1},
        {"name": "K3 nearest_neighbor", "route": "cuda", "source": "rivslam_tpu_torch/csrc/nn_argmin.cu",
         "replaces": "rivslam_tpu/ops/pallas_nn.py:29", "launches": k3_eng,
         "max_abs_err": k3_err, **k3["engine"]},
    ]
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
