"""Drive the PyTorch/CUDA port (rivslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced by a flushed "== phase" line:
  1. device   the card's name and power limit (nvidia-smi) and device count;
 1b. draws    the RANSAC draws (core/prng.py, JAX's threefry key chain):
              engine seed 0's subkeys for frames 0-2 against jax.random's
              words, their uniform draws (128 x capacity, float32 and
              float64) on the card against the CPU's, bitwise, and against
              jax.random's values at a few places (GOLDEN_DRAWS); the host
              and card time of one frame's draw, eager, beside the
              torch.Generator draw it replaced;
  2. build    K1 (csrc/nn_gather.cu), K2 (csrc/nn_corr.cu), K3
              (csrc/nn_argmin.cu) and the window solve (csrc/window_lm.cu),
              one nvcc each, started together; wall times, ptxas reports,
              and each nearest-neighbour scan loop's instructions per
              (query, target) pair from cuobjdump -sass;
  3. data     bench.py's protocol: B=256 frame pairs, capacity N=M=1024,
              from the port's numpy copy of the simulator;
  4. K1       both block shapes of the kernel against its plain twin on the
              card, on the main path's inputs and on ragged, fully masked
              and exact-tie cases; the exact ties in the main path's inputs,
              counted with the twin's arithmetic; and at the scan-to-map
              shape (B=1, N=1024, M=5120) on the submap of the garden
              preset's first frames, with exact ties across every 1024-ref
              tile edge;
  5. main     prepare (KNN, then RBF) + register_dispatch with the fused
              correspondence kernel on, launch counts read around the run;
              convergence and per-pair error against the ground truth, the
              flag-off path and a small input against the CPU run;
  6. timing   CUDA-event times: frames/s with the kernel on and off, K1 per
              launch beside its plain twin, the flag-off correspondence step
              (library_ms) and the least time the card could take (bound_ms);
  7. K2       the kernel against its plain twin on the card: the exact
              path's own inputs (F = 12), B=256 at full width, ragged,
              masked, exact ties across the 512-ref tile edge, F=1 and 128;
              split_for's choice at B=256 and B=1, and every split S =
              1..8 on the engine's shape with ties across the slice
              boundaries at F = 12, 9 and 128, bitwise;
  8. exact    the exact scan match (use_fast_path=False) on the same B=256
              pairs for FAST_APDGICP (KNN and RBF covariances), GICP and
              ICP, K2 launches read around each; convergence, error, and a
              small input against the CPU run;
  9. engine   the "cp" preset as shipped (loop closure on, K1 on) over the
              120-frame "cp" validation course at capacity 1024, engine
              seed 0 (seeds 1 and 2: profile_torch.py --digest, which holds
              them to the same limits): the loop-corrected ATE and the window
              backend's own (uncorrected) ATE, each held to 1.5x the JAX
              engine's for the same seed; keyframes, loops closed,
              loop_stats, per-frame latency, peak memory, K1/K2/K3 launches
              (counted through the graph replays) and the window kernel's
              (one a frame, checked in phase 9), the CUDA graph replays
              (preintegration, registration), the window kernel's launches,
              outer iterations and lambda tries, and the registration's
              host reads; each run's per-frame position gap
              to the JAX engine's run of the same seed and configuration
              (JAX_RUNS: median, largest, the first frame past 1 cm, the
              first keyframe decision that differs, loops beside JAX's),
              the largest held to max_gap_m; the Engine's graphed draw,
              one replay a frame, bitwise the CPU's, and its host time; then
              the first 8 frames of the loop-off path on the card against
              the CPU;
 10. engine   the same course through the exact registration
     exact    (validation.build_course_cfg("cp", use_fast_path=False)): K2
              launches, graph replays and host reads, ATE held to 1.5x the
              JAX engine's, the per-frame gap to its run, loops closed;
 11. K3       the kernel against its plain twin on the card: the engine's
              fitness inputs, B=256, ragged, masked and exact-tie cases,
              every split S = 1..8 with ties across the slice boundaries;
              K2 and K1 on the exact and the preset engine's last
              correspondence step;
 12. timing   K1, K2 and K3 per launch on the same inputs: the scan-match
              pairs (B=256), random clouds (B=256) and the preset engine's
              registration shape (B=1, N=M=1024); K2 at the exact engine's
              shape and K3 at the engine's fitness inputs; the plain twins,
              the library compositions and the bounds; the A/B of K1's
              two block shapes at B=256 and B=1, in turns; K2 and K3 on the
              engine's inputs at every split S, beside the floor (an empty
              kernel on the same clustered grid), in a CUDA graph; K1 at the
              scan-to-map shape (B=1, N=1024, M=5120) in a CUDA graph;
 12b. window  the window solve of phase 9's seed-0 run: its launches (one
              a frame), outer iterations and lambda tries a solve; on the
              run's newest window (rebuilt from the backend states before
              and after its last frame, held to the kernel's bitwise) the
              kernel's ms a launch (CUDA events), a whole solve's host ms
              (launch and read), the plain twin's on the card, the bound
              (the operations of the factorizations and solves it ran, and
              the floor of one host-launched empty kernel and one host
              read), and the gap to the twin on the CPU, held to the card
              tests' limits (tests/torch_window_problem.twin_limits: three
              times the twin's own spread on the window, or WINDOW_TOL);
 13. engine   the 260-frame "garden" validation course under its
     garden   configuration (validation.build_course_cfg("garden"), K1 on:
              the garden preset, scan-to-map odometry, without deskew or
              under-floor removal for the instantaneous synthetic scans,
              where loops close often; the preset as shipped runs in
              profile_torch.py --digest), engine seed 0: ATE corrected and uncorrected, each
              held to 1.5x the JAX engine's, loops closed (at least 1),
              keyframes, per-frame latency (median, p95, max, frames over
              the 250 ms frame interval), K1 launches at each registration
              shape and K3's, graph replays, peak memory, trajectory digest;
 14. async    the asynchronous loop worker: the cp course, seed 0, drained
              after every frame, must give phase 9's seed-0 digest; then
              the garden course's configuration free-running (drained at
              finalize only): loops closed (at least 1), keyframes skipped
              while the worker was busy, the worker's launches, ATE and
              latency beside phase 13's synchronous run;
 15. CLI      python -m rivslam_tpu_torch --device cuda on a short garden
              course written to .npz and .rivbin: --preset garden
              --async-loop --ckpt, then --resume of that checkpoint; the TUM
              outputs checked.
 16. replay   Engine.replay_sequence over the cp course (the cp preset, loop
              closure off, K1 on), launch counts read around it: its
              trajectory digest must equal the process_frame loop-off run's
              on the same frames and seed (driven here, held to the JAX
              engine's loop-off ATE and, frame by frame, to the window
              backend's trajectory of its seed-0 run); frames/s beside the
              process_frame loop's;
              the host syncs of each frame step (torch.cuda.set_sync_debug_mode)
              in the replay and in process_frame on 20 frames; K2 through an
              exact-path replay;
 17. fleet    Engine.replay_fleet of two 40-frame stretches of the cp course
              (B=2): each sequence's digest must equal its single replay on
              an Engine keyed fold_in(key(seed), b), as the reference keys
              it; per-sequence frames/s;
 18. voxel    the cp course through the validation harness's configuration
              with method VGICP and with NDT_OMP (loop closure on): ATE held
              to 1.5x the JAX engine's, the per-frame gap to its run, loops,
              latency, digest;
 19. CLI      python -m rivslam_tpu_torch --device cuda --device-replay on
     replay   16 cp frames (.npz, --map): the TUM output and the frames/s line;
 20. dist     the distributed layer (rivslam_tpu_torch/dist/) on a NCCL world
              of 1 (dist.mesh.init_world, a file:// store, 60 s timeout) and a
              (1, 1) mesh: batched_register at B=8 exact pairs against
              register on the same batch and sharded_register against
              register, bitwise, K2 counted through each;
              batched_replay_odometry (S=2) against replay_odometry,
              bitwise, K1 counted; solve_pose_graph_sharded and
              solve_pose_graph_schur_sharded against their local twins
              (float64, within 1e-6); replay_fleet(mesh=) at B=2 against
              phase 17's digests; the phase's wall time.

Any failed check raises, and the script then exits non-zero without a
result. The line before the last is a JSON object listing the kernels, each
at the engine's shape (B=1) and at B=256, and K1 at the scan-to-map shape,
with their launches in the replay (phase 16; K2's in the exact replay; K1 at
the scan-to-map shape in the garden course run), and the window solve at
the engine's window (its launches in phase 9's seed-0 run); the last line is
{"ok": true, "device": {...}}. It needs a CUDA device and the
repository beside it: there is no CPU fallback.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

B, CAPACITY = 256, 1024  # bench.py:50-53
# The bound of the three nearest-neighbour kernels is instructions: per
# (query, valid target) pair the distance takes 8 unfused float32
# instructions (each product and sum rounded on its own, no FMA), the
# running minimum a compare and two selects. A Hopper SM issues 128
# thread-instructions a clock, so the card's rate is SMs x 128 x its
# maximum SM clock, read from the card (phase 1). Phase 2 prints each scan
# loop's count from cuobjdump -sass beside this one.
INSTR_PER_PAIR = 11
LANES_PER_SM = 128
H100_BYTES = 3.35e12  # HBM3, H100 SXM data sheet
MIN_CONVERGED = 0.9
MAX_MEDIAN_TERR_M = 0.1
# the engine phases: the "cp" validation course (rivslam_tpu/eval/validation.py:42)
COURSE = dict(seed=21, radius=8.0, omega=0.25, dt=0.25, n_frames=120, capacity=1024,
              world_points=20000, extent=30.0)
ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, ENGINE_SEED = 1024, 64, 0
# the preset run's engine seeds here (the exact run: seed 0); seeds 1 and 2
# run in `profile_torch.py --digest`, which holds them to REF too
ENGINE_SEEDS = (0,)
# the JAX engine on this course and seeds, float32 on the CPU
# (`PYTHONPATH=. python tests/test_torch_engine_loop.py`): full-trajectory
# ATE after loop correction, the window backend's own ATE (what the engine
# gives with loop closure off: tests/test_torch_engine.py), keyframes and
# loops closed, by engine seed (seeds 1 and 2: profile_torch.py --digest)
REF = {
    "preset": {
        0: {"ate_m": 0.28056248288268654, "uncorrected_ate_m": 0.7365842276827688, "keyframes": 75, "loops": 1},
        1: {"ate_m": 0.1887125756414635, "uncorrected_ate_m": 0.7636182678317872, "keyframes": 76, "loops": 1},
        2: {"ate_m": 0.34955880087721614, "uncorrected_ate_m": 0.6301865835767001, "keyframes": 75, "loops": 2},
    },
    "exact": {
        0: {"ate_m": 0.24116977638213324, "uncorrected_ate_m": 0.7587948732727486, "keyframes": 78, "loops": 2},
    },
    # `PYTHONPATH=.:tests python tests/test_torch_scan2map.py`: over the
    # garden course, the garden preset as shipped (scan-to-map on; held in
    # profile_torch.py --digest), and the garden course's configuration
    # (validation.build_course_cfg)
    "garden": {
        0: {"ate_m": 23.307262101356596, "uncorrected_ate_m": 25.266290100142566, "keyframes": 230, "loops": 2},
    },
    "garden-course": {
        0: {"ate_m": 0.6870941896367062, "uncorrected_ate_m": 3.773917581948221, "keyframes": 258, "loops": 19},
    },
    # `PYTHONPATH=. python tests/test_torch_engine.py`: the cp preset with loop
    # closure off (phase 16's per-frame run; the replay has no loop stage)
    "loop-off": {
        0: {"ate_m": 0.7365842276827688, "uncorrected_ate_m": 0.7365842276827688, "keyframes": 75, "loops": 0},
    },
    # `PYTHONPATH=.:tests python tests/test_torch_vgicp.py`: the cp course under
    # the validation harness's configuration with method VGICP / NDT_OMP. The
    # JAX package's VGICP is not fast_gicp's (ROADMAP F8: NDT's voxel, no
    # sqrt(N_v)), so VGICP's figures are the port's own CPU float32 run
    # (`PYTHONPATH=.:tests python tests/test_torch_engine_loop.py --port vgicp0`)
    "vgicp": {
        0: {"ate_m": 0.7041496145266778, "uncorrected_ate_m": 0.7705204212072492, "keyframes": 81, "loops": 1},
    },
    "ndt": {
        0: {"ate_m": 1.4667459164161616, "uncorrected_ate_m": 2.175324503480315, "keyframes": 76, "loops": 1},
    },
}
MAX_ATE_RATIO = 1.5
# the JAX engine's runs behind REF, frame by frame (positions loop-corrected
# and the window backend's own, keyframe and loop flags, correspondences;
# written by the script modes of tests/test_torch_engine_loop.py and
# tests/test_torch_vgicp.py), by run: preset0-2, exact0, vgicp0, ndt0
JAX_RUNS = os.path.join("tests", "torch_ref", "cp_f32.npz")
GAP_FRAME_M = 0.01  # the gap lines name the first frame past 1 cm
# The per-frame position gap a run may keep from its JAX run. The port on
# the CPU in float32, with the same draws, parts from the JAX run at frame 1
# already: XLA contracts the reference's multiply-adds into fused ones and
# sums its matmuls in another order, and the RBF covariance of a
# near-isolated point (E[xx^T] - m m^T of ~900 m^2 terms) is that rounding,
# amplified. So a run is held to twice the largest gap of the CPU runs of its
# configuration (any seed, either trajectory; `PYTHONPATH=.:tests python
# tests/test_torch_engine_loop.py --port preset0 ...`), plus 2 cm, as the
# card-vs-CPU check below holds its band. The loop-off run is the preset's.
# (VGICP's: the port's fast_gicp VGICP against the JAX package's, F8)
CPU_GAP_M = {"preset": 1.6356, "exact": 0.6434, "vgicp": 2.7452, "ndt": 0.0129}
GAP_FACTOR, GAP_FLOOR_M = 2.0, 0.02
# jax.random 0.9.0 (threefry, partitionable) for engine seed 0: frame f's
# subkey (key, k1 = split(key), frames 0-2) and uniform(k1, (128, 1024)) at
# GOLDEN_AT in float32 and in float64, as float.hex: the card has no JAX
GOLDEN_AT = ((0, 0), (0, 1), (2, 1023), (3, 0), (127, 1023))
GOLDEN_DRAWS = (
    ((928981903, 3453687069),
     ("0x1.de02000000000p-8", "0x1.5648000000000p-6", "0x1.92f25c0000000p-1", "0x1.88f99c0000000p-1",
      "0x1.9c8f380000000p-1"),
     ("0x1.4a3cc6a157dc0p-4", "0x1.d90fd25fd3bd8p-1", "0x1.5aa9830f11608p-3", "0x1.fca9968fdf4f8p-3",
      "0x1.34a437382ac00p-10")),
    ((1353695780, 2116000888),
     ("0x1.ab2c600000000p-4", "0x1.603e480000000p-2", "0x1.60feb00000000p-1", "0x1.abd3a80000000p-1",
      "0x1.2356000000000p-6"),
     ("0x1.57a69b6f62c30p-1", "0x1.83ed66fb33f24p-1", "0x1.4b86896e2b782p-1", "0x1.a5a958400e7aep-1",
      "0x1.916f96e9835acp-2")),
    ((3531307783, 465290248),
     ("0x1.5258600000000p-4", "0x1.8fc3540000000p-1", "0x1.916d500000000p-1", "0x1.618acc0000000p-1",
      "0x1.3395640000000p-1"),
     ("0x1.681b38e93c8d0p-2", "0x1.a7f5decab8734p-2", "0x1.1f5adef08e378p-1", "0x1.e1d0b07322c50p-2",
      "0x1.2d5e17b5e30b8p-3")),
)
# the garden phases: the "garden" validation course (rivslam_tpu/eval/validation.py:50)
GARDEN_COURSE = dict(seed=21, radius=15.0, omega=0.2, dt=0.25, n_frames=260, capacity=1024,
                     world_points=24000, extent=45.0)
GARDEN_HEAD = 12  # phase 4's garden frames, for a submap of several keyframes
CLI_FRAMES = 16  # phase 15's course, and phase 19's
SYNC_FRAMES = 20  # phase 16: the frames whose host syncs are counted
FLEET_FRAMES = 40  # phase 17: the length of each fleet sequence
F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
FRAME_INTERVAL_MS = 250.0  # the radar's frame interval
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


def time_ms(fn, reps: int, warmup: int = 1, graph: bool = False) -> float:
    """Mean time of fn() over reps calls, by CUDA events. With ``graph`` the
    reps calls are captured in one CUDA graph and the graph is timed, so
    the host's launch overhead drops out: the device time per call, what a
    small (B=1) launch costs inside the engine's graphs and streams."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for _ in range(reps):
            fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k1_ties(nn_gather, q, r, m, f):
    """The twin's tie counts [B, N] (valid targets at each query's minimum)
    and how far K1's features may lie from the twin's [B, F, N]: zero for
    one winner or a tie of two, where the order of the sum cannot matter. A
    tie of n >= 3 is summed in ascending index order by K1 and in the
    equality bmm's order by the twin; each order rounds n - 1 additions by
    up to half an ulp of the partial sums, so the two sums differ by at most
    n - 1 ulps of the sum of the tied features' magnitudes (all orders of 3-
    and 4-term float32 sums reach 2 ulps), which the division by n scales,
    and the two quotients round by up to an ulp of the mean."""
    _, abs_sum, cnt = nn_gather._plain_scan(q, r, m, f.abs())
    _, g_sum, _ = nn_gather._plain_scan(q, r, m, f)
    n = torch.clamp_min(cnt, 1.0)[:, None]

    def ulp(x):
        return torch.nextafter(x, torch.full_like(x, torch.inf)) - x

    tol = (n - 1.0) * ulp(abs_sum) / n + ulp((g_sum / n).abs())
    return cnt.to(torch.int32), torch.where((cnt >= 3)[:, None], tol, 0.0)


def compare_k1(name, nn_gather, q, r, m, f, variant=None):
    """K1 (the block shape ``variant``, default the one the port launches)
    against its plain twin on the same inputs: d2 bitwise, the features
    bitwise for one winner or a tie of two; a tie of three or more within
    k1_ties' tolerance (the twin's equality bmm sums in the library's order,
    K1 in index order). Returns (max abs error, d2, g, tie counts)."""
    if variant is None:
        variant = nn_gather.variant_for(q.shape[0], q.shape[1], q.device)
        d2, g = nn_gather.fused_gather(q, r, m, f)
    else:
        d2, g = nn_gather._launch(q, r, m, f, variant)
    pd2, pg = nn_gather.fused_gather_plain(q, r, m, f)
    cnt, tol = k1_ties(nn_gather, q, r, m, f)
    torch.cuda.synchronize()
    vname = variant.name
    check(bool(torch.isfinite(g).all()), f"K1 {vname} {name}: non-finite features")
    check(torch.equal(d2, pd2), f"K1 {vname} {name}: d2 differs from the plain twin by up to "
          f"{(d2 - pd2).abs().max().item()}")
    few = (cnt <= 2)[:, None, :].expand_as(g)
    check(torch.equal(g[few], pg[few]), f"K1 {vname} {name}: features of one winner or a "
          "two-way tie differ from the plain twin")
    g_err = (g - pg).abs()
    check(bool((g_err <= tol).all()), f"K1 {vname} {name}: tie features beyond the tie-sum tolerance")
    err = g_err.max().item() if g.numel() else 0.0
    say(f"K1 {vname} {name}: B,N,M,F={tuple(q.shape[:2]) + (r.shape[1], f.shape[1])} d2 bitwise "
        f"equal; features bitwise equal but for {int((cnt >= 3).sum())} ties of 3 or more "
        f"(max|g-plain| {err:.3e})")
    return err, d2, g, cnt


def k1_cases(nn_gather, dev, variant=None):
    """Ragged sizes, fully masked targets and injected exact ties."""
    rng = np.random.default_rng(7)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)

    # ragged: N, M not multiples of the 128-query block or the target tiles
    q = t(rng.normal(size=(3, 1000, 3)) * 10)
    r = t(rng.normal(size=(3, 1500, 3)) * 10)
    m = t(rng.uniform(size=(3, 1500)) > 0.15, torch.bool)
    f = t(rng.normal(size=(3, 9, 1500)))
    errs = [compare_k1("ragged", nn_gather, q, r, m, f, variant)[0]]

    # fully masked target in problem 0, partly masked in problem 1
    m = t(np.stack([np.zeros(1500, bool), rng.uniform(size=1500) > 0.5, np.ones(1500, bool)]),
          torch.bool)
    err, d2, g, _ = compare_k1("masked", nn_gather, q, r, m, f, variant)
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
    err, d2, g, _ = compare_k1("ties", nn_gather, q, r, m, f, variant)
    f32 = ff.astype(np.float32)
    want = (f32[:, :, 50:256] + f32[:, :, 1074:1280]) / np.float32(2)
    got = g[:, :, 50:256].cpu().numpy()
    check(np.array_equal(got, want), "K1 ties: two-way ties are not averaged")
    errs.append(err)
    return max(errs)


def sass_scan_loops(lib_path: str) -> dict | None:
    """Each kernel's main scan loop in a built library, read from
    ``cuobjdump -sass``: of the innermost loops (backward branches with no
    other inside), the one whose body holds the most float arithmetic. Per
    kernel: the body's instruction counts by class and the (query, target)
    pairs it covers (8 arithmetic instructions each). None when the toolkit
    has no cuobjdump."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    exe = exe if os.path.exists(exe) else shutil.which("cuobjdump")
    if not exe:
        return None
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    classes = {"arith": ("FMUL", "FADD", "FFMA"), "compare": ("FSETP", "ISETP", "PLOP3"),
               "select": ("FSEL", "SEL", "MOV", "IMAD.MOV", "IADD3", "VIADD"), "shared": ("LDS",)}
    report = {}
    for name, ins in funcs.items():
        back = []
        for addr, text in ins:
            m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                back.append((int(m.group(1), 16), addr))
        best = None
        for lo, hi in back:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in back):
                continue  # not innermost
            ops = [re.sub(r"^@!?U?P[T0-9]\s+", "", t).split()[0] for a, t in ins if lo <= a <= hi]
            counts = {c: sum(any(o == p or o.startswith(p + ".") for p in pre) for o in ops)
                      for c, pre in classes.items()}
            counts["ffma"] = sum(o.startswith("FFMA") for o in ops)
            counts["total"] = len(ops)
            if best is None or counts["arith"] > best["arith"]:
                best = counts
        if best and best["arith"] >= 8:
            best["pairs"] = best["arith"] / 8
            report[name] = best
    return report


def compare_k3(name, nn_argmin, q, r, m, splits=None):
    """K3 (with the refs in ``splits`` slices; default the wrapper's choice)
    against its plain twin: d2 bitwise, idx equal. Returns max|d2 err|."""
    if splits is None:
        idx, d2 = nn_argmin.nearest_neighbor(q, r, m)
    else:
        idx, d2 = nn_argmin._launch(q, r, m, splits)
        name = f"{name}, S={splits}"
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


def compare_k2(name, nn_corr, q, r, m, f, splits=None):
    """K2 (with the refs in ``splits`` slices; default the wrapper's choice)
    against its plain twin: idx and g equal, d2 bitwise. Returns max|err|."""
    if splits is None:
        idx, d2, g = nn_corr.fused_correspondence(q, r, m, f)
    else:
        idx, d2, g = nn_corr._launch(q, r, m, f, splits)
        name = f"{name}, S={splits}"
    pidx, pd2, pg = nn_corr.fused_correspondence_plain(q, r, m, f)
    torch.cuda.synchronize()
    err = max((d2 - pd2).abs().max().item(), (g - pg).abs().max().item())
    check(err == 0.0, f"K2 {name}: d2 or g differs from the plain twin by {err}")
    check(bool(torch.equal(idx, pidx)), f"K2 {name}: idx differs from the plain twin "
          f"at {int((idx != pidx).sum())} queries")
    check(bool(torch.equal(g, pg)), f"K2 {name}: gathered rows differ from the plain twin")
    say(f"K2 {name}: B,N,M,F={tuple(q.shape[:2]) + (r.shape[1], f.shape[2])} "
        f"max|err|={err:.3e}, idx and g equal")
    return err, idx, d2, g


def exact_corr_inputs(prep, xyz):
    """What the exact registration hands K2 (frontend/apdgicp.register):
    query points, the target with masked rows at the sentinel, its mask, and
    its xyz + full covariance as F = 12 features."""
    from rivslam_tpu_torch.core.pointcloud import SENTINEL

    Bq, M = prep.xyz.shape[:2]
    ref = torch.where(prep.mask[..., None], prep.xyz, SENTINEL).contiguous()
    feats = torch.cat([prep.xyz, prep.cov.reshape(Bq, M, 9)], dim=-1).contiguous()
    return xyz.contiguous(), ref, prep.mask.contiguous(), feats


def k2_cases(nn_corr, dev):
    """B=256 at full width, ragged sizes, masked refs, exact ties, F=1/128."""
    rng = np.random.default_rng(10)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    errs = []
    q, r = t(rng.normal(size=(256, 1024, 3)) * 10), t(rng.normal(size=(256, 1024, 3)) * 10)
    m = t(rng.uniform(size=(256, 1024)) > 0.1, torch.bool)
    errs.append(compare_k2("B=256", nn_corr, q, r, m, t(rng.normal(size=(256, 1024, 12))))[0])
    q, r = t(rng.normal(size=(3, 1000, 3)) * 10), t(rng.normal(size=(3, 1500, 3)) * 10)
    f = t(rng.normal(size=(3, 1500, 12)))
    errs.append(compare_k2("ragged", nn_corr, q, r, t(rng.uniform(size=(3, 1500)) > 0.15, torch.bool), f)[0])
    m = t(np.stack([np.zeros(1500, bool), rng.uniform(size=1500) > 0.5, np.ones(1500, bool)]), torch.bool)
    err, idx, d2, g = compare_k2("masked", nn_corr, q, r, m, f)
    check(bool((d2[0] == 1e30).all()) and bool((idx[0] == 0).all()) and bool((g[0] == 0).all()),
          "K2 masked: a problem without valid refs must give d2 1e30, idx 0 and zero rows")
    check(bool(m[1][idx[1].long()].all()), "K2 masked: a masked ref won")
    errs.append(err)
    # exact ties: refs 512..767 copy refs 0..255 (across the 512-ref tile),
    # 300..349 copy 0..49; queries 0..255 sit on refs 0..255: the first wins
    rr = rng.normal(size=(2, 1100, 3)) * 10
    rr[:, 512:768] = rr[:, :256]
    rr[:, 300:350] = rr[:, :50]
    qq = rng.normal(size=(2, 700, 3)) * 10
    qq[:, :256] = rr[:, :256]
    ff = t(rng.normal(size=(2, 1100, 12)))
    err, idx, _, g = compare_k2("ties", nn_corr, t(qq), t(rr), torch.ones((2, 1100), dtype=torch.bool, device=dev), ff)
    check(bool((idx[:, :256] == torch.arange(256, device=dev)).all()), "K2 ties: the first index must win")
    check(bool(torch.equal(g[:, :256], ff[:, :256])), "K2 ties: the first index's row must be gathered")
    errs.append(err)
    for F in (1, 128):
        q, r = t(rng.normal(size=(2, 700, 3)) * 10), t(rng.normal(size=(2, 900, 3)) * 10)
        m = t(rng.uniform(size=(2, 900)) > 0.2, torch.bool)
        errs.append(compare_k2(f"F={F}", nn_corr, q, r, m, t(rng.normal(size=(2, 900, F))))[0])
    return max(errs)


def split_inputs(dev, splits, F=12, seed=12, keep=0.3, N=1024, M=1024):
    """The engine's shape (B=1, N=M=1024, about 30% of the refs valid, as the
    engine's clouds) with exact ties on either side of every boundary of
    ``splits`` slices (block s scans the valid refs of rank [s V / S,
    (s + 1) V / S)): the last valid ref of each slice is copied onto the
    first of the next, and query s sits on it (the earlier index must win);
    a masked ref below each copy sits on query s too (it must never win).
    Returns the inputs and the (query, winner) pairs."""
    rng = np.random.default_rng(seed + splits)
    r = rng.normal(size=(1, M, 3)) * 10
    m = rng.uniform(size=(1, M)) < keep
    q = rng.normal(size=(1, N, 3)) * 10
    valid = np.flatnonzero(m[0])
    ties = []
    for s_ in range(1, splits):
        lo, hi = valid[len(valid) * s_ // splits - 1], valid[len(valid) * s_ // splits]
        r[0, hi] = r[0, lo]
        q[0, s_] = r[0, lo]
        r[0, np.flatnonzero(~m[0, :lo])[-1]] = r[0, lo]
        ties.append((s_, lo))
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    f = t(rng.normal(size=(1, M, F)))
    return (t(q), t(r), t(m, torch.bool), f), ties


def k3_split_cases(nn_argmin, dev):
    """K3 at every split S = 1..MAX_SPLIT on the engine's shape with ties
    across the slice boundaries, bitwise against its twin."""
    errs = []
    for S in range(1, nn_argmin.MAX_SPLIT + 1):
        (q, r, m, _), ties = split_inputs(dev, S)
        err, idx, _ = compare_k3("engine shape, ties across slices", nn_argmin, q, r, m, S)
        check(all(int(idx[0, qi]) == lo for qi, lo in ties),
              f"K3 S={S}: a tie across a slice boundary did not go to the earlier index")
        errs.append(err)
    return max(errs)


def k2_split_cases(nn_corr, nn_argmin, dev):
    """K2 at every split S = 1..MAX_SPLIT on the engine's shape with ties
    across the slice boundaries, F = 12 (the exact path's), 9 and 128,
    bitwise against its twin."""
    errs = []
    for S in range(1, nn_argmin.MAX_SPLIT + 1):
        for F in (12, 9, 128):
            (q, r, m, f), ties = split_inputs(dev, S, F=F)
            err, idx, _, g = compare_k2(f"engine shape, ties across slices, F={F}", nn_corr,
                                        q, r, m, f, S)
            check(all(int(idx[0, qi]) == lo and torch.equal(g[0, qi], f[0, lo]) for qi, lo in ties),
                  f"K2 S={S}: a tie across a slice boundary did not go to the earlier index")
            errs.append(err)
    return max(errs)


def loop_off_cfg(presets):
    """The loop-off engine configuration: the "cp" preset, loop closure
    off, K1 on (the card-vs-CPU check and ``profile_torch.py --engine``)."""
    cfg = preset_cfg(presets)
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enable=False))


def preset_cfg(presets):
    """The "cp" preset as shipped (loop closure on), with K1 on."""
    cfg = presets.get("cp")
    return dataclasses.replace(
        cfg, registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )


def garden_cfg(presets):
    """The "garden" preset as shipped (scan-to-map odometry and loop closure
    on), with K1 on, as phase 9 runs the cp preset."""
    cfg = presets.get("garden")
    return dataclasses.replace(
        cfg, registration=dataclasses.replace(cfg.registration, use_pallas_correspondence=True),
    )


def frames(seq, a, b):
    """The sequence's frames a..b-1 (the IMU stream whole)."""
    o = seq.offsets
    return dataclasses.replace(seq, frame_stamps=seq.frame_stamps[a:b], offsets=o[a:b + 1] - o[a],
                               xyz=seq.xyz[o[a]:o[b]], doppler=seq.doppler[o[a]:o[b]],
                               intensity=seq.intensity[o[a]:o[b]])


def submap_k1_inputs(eng, SENTINEL, dev):
    """K1's inputs at the scan-to-map shape from a garden engine's state:
    the last keyframe cloud as queries against the merged submap (B=1,
    N=1024, M=5120), with exact ties across every 1024-ref tile edge: the
    last valid ref below an edge is copied onto the first valid ref above
    it (their features differ: the two are averaged), and query s sits on
    edge s's pair. Returns the inputs and (query, below, above) per edge."""
    tgt = eng.state.odo.target
    M = tgt.xyz.shape[0]
    xyz = tgt.xyz.clone()
    mask = tgt.mask.cpu().numpy()
    q = eng.state.kf_clouds[-1][0].clone()
    ties = []
    for s_, edge in enumerate(range(1024, M, 1024)):
        lo = int(np.flatnonzero(mask[:edge])[-1])
        hi = int(edge + np.flatnonzero(mask[edge:])[0])
        xyz[hi] = xyz[lo]
        q[s_] = xyz[lo]
        ties.append((s_, lo, hi))
    c = tgt.cov
    feats_t = torch.stack(list(tgt.xyz.unbind(-1)) + [c[..., 0, 0], c[..., 0, 1], c[..., 0, 2],
                                                     c[..., 1, 1], c[..., 1, 2], c[..., 2, 2]], dim=0)
    ref = torch.where(tgt.mask[:, None], xyz, SENTINEL)
    return (q[None].contiguous(), ref[None].contiguous(), tgt.mask[None].contiguous(),
            feats_t[None].contiguous()), ties


def exact_cfg():
    """The cp course's configuration with the exact registration, as the
    port's validation harness builds it (eval/validation.build_course_cfg)."""
    from rivslam_tpu_torch.eval import validation

    return validation.build_course_cfg("cp", reg_overrides={"use_fast_path": False})


def garden_course_cfg():
    """The garden course's configuration (scan-to-map on, as the garden
    preset ships it), K1 on."""
    from rivslam_tpu_torch.eval import validation

    return validation.build_course_cfg("garden", reg_overrides={"use_pallas_correspondence": True})


def voxel_cfg(method):
    """The cp course's configuration with a voxel registration (VGICP or
    NDT_OMP), as the validation harness builds it."""
    from rivslam_tpu_torch.eval import validation

    return validation.build_course_cfg("cp", method)


def count_syncs(eng, drive) -> tuple[list[int], list[int], int]:
    """Run ``drive()`` with torch's sync debug mode on and count the
    synchronizing CUDA calls (host reads, synchronous copies): inside each
    call of ``eng``'s frame step (``Engine._frame_step``, which
    ``process_frame`` and ``replay_sequence`` share), the running count at
    the end of each, and the run's total."""
    per_step, at_end = [], []
    step = eng._frame_step
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def syncs():
            return sum("synchroniz" in str(w.message) for w in caught)

        def counted(*args, **kw):
            n0 = syncs()
            out = step(*args, **kw)
            at_end.append(syncs())
            per_step.append(at_end[-1] - n0)
            return out

        eng._frame_step = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            drive()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del eng._frame_step
        return per_step, at_end, syncs()


def nudged(seq, nudge: str | None):
    """The course with every point's coordinates moved one float32 ulp
    ("up" or "down"), or as it is (None): a change at the size of float32
    rounding, which shows how far an engine's own float32 run moves."""
    if nudge is None:
        return seq
    if nudge not in ("up", "down"):
        raise ValueError(f"a nudge is up or down, not {nudge!r}")
    xyz = seq.xyz.astype(np.float32)
    return dataclasses.replace(seq, xyz=np.nextafter(xyz, np.float32(np.inf if nudge == "up" else -np.inf)))


def max_gap_m(key: str) -> float:
    """The largest per-frame position gap engine run ``key`` may keep from
    its JAX run."""
    return GAP_FACTOR * CPU_GAP_M["preset" if key == "loop-off" else key] + GAP_FLOOR_M


def jax_run_name(key: str, seed: int) -> tuple[str, tuple[str, ...]]:
    """The JAX run in JAX_RUNS that engine run ``key`` of ``seed`` is held
    to, and which of its trajectories: the loop-off run is the loop-on
    run's window backend (its own, uncorrected, trajectory)."""
    if key == "loop-off":
        return f"preset{seed}", ("uncorrected",)
    return f"{key}{seed}", ("corrected", "uncorrected")


def jax_gap(ref, name: str, positions: dict, keyframes, loop_frames=None, correspondences=None) -> dict:
    """A run against the JAX engine's run ``name`` of the same seed
    (``ref``: JAX_RUNS loaded): for each trajectory in ``positions``
    ("corrected", "uncorrected": [F, 3]) the per-frame position gap's
    median and largest (m) and the first frame past GAP_FRAME_M; the first
    frame whose keyframe decision differs (None: none does) and both
    keyframe counts; both runs' loop frames; the first frame whose
    odometry correspondence count differs."""
    out = {}
    for tag, p in positions.items():
        d = np.linalg.norm(np.asarray(p, np.float64) - ref[f"{name}_{tag}"], axis=1)
        over = np.flatnonzero(d > GAP_FRAME_M)
        out[tag] = {"median_m": float(np.median(d)), "max_m": float(d.max()),
                    "first_over_1cm": int(over[0]) if over.size else None}
    kf = ref[f"{name}_keyframe"]
    split = np.flatnonzero(np.asarray(keyframes, bool) != kf)
    out["first_keyframe_split"] = int(split[0]) if split.size else None
    out["keyframes"] = [int(np.sum(keyframes)), int(kf.sum())]
    if loop_frames is not None:
        out["loop_frames"] = [list(loop_frames), np.flatnonzero(ref[f"{name}_loop"]).tolist()]
    if correspondences is not None:
        split = np.flatnonzero(np.asarray(correspondences) != ref[f"{name}_correspondences"])
        out["first_correspondence_split"] = int(split[0]) if split.size else None
    return out


def digest_of(poses: np.ndarray) -> str:
    """drive_engine's digest of a loop-free run: its corrected and
    uncorrected trajectories are the same poses."""
    h = hashlib.sha256()
    for _ in range(2):
        h.update(np.ascontiguousarray(poses).tobytes())
    return h.hexdigest()


def run_main(apdgicp, cfg, data, guess, dev):
    src_xyz, src_mask, tgt_xyz, tgt_mask = data
    tgt = apdgicp.prepare(tgt_xyz, tgt_mask, cfg, device=dev)
    src = apdgicp.prepare(src_xyz, src_mask, cfg, device=dev)
    return apdgicp.register_dispatch(src, tgt, guess, cfg, device=dev)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import rivslam_tpu_torch
    from rivslam_tpu_torch.core.config import RegistrationConfig
    from rivslam_tpu_torch.core.pointcloud import SENTINEL
    from rivslam_tpu_torch.frontend import apdgicp
    from rivslam_tpu_torch import pipeline, presets
    from rivslam_tpu_torch.core import lie
    from rivslam_tpu_torch.eval import ate
    from rivslam_tpu_torch.io import datasets, synthetic
    from rivslam_tpu_torch.backend import slam
    from rivslam_tpu_torch.core.navstate import NavState
    from rivslam_tpu_torch.factors import preintegration as pre
    from rivslam_tpu_torch.ops import cuda_build, nn_argmin, nn_corr, nn_gather
    from rivslam_tpu_torch.solver import window
    from torch_window_problem import twin_limits  # the card tests' limits, kernel against twin

    dev = torch.device("cuda")
    counted = {"K1": nn_gather.fused_gather, "K2": nn_corr.fused_correspondence, "window": window.solve_batched,
               "K3": nn_argmin.nearest_neighbor}

    def zero_counts():
        for fn in counted.values():
            fn.launches = fn.worker_launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

    def read_worker_counts():  # the asynchronous loop worker's launches
        return {name: fn.worker_launches for name, fn in counted.items()}
    t_start = time.perf_counter()

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instr_rate = sms * LANES_PER_SM * clock_mhz * 1e6
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind!r}, count {count}; "
        f"{sms} SMs at a maximum SM clock of {clock_mhz:.0f} MHz: {instr_rate:.4e} float32 "
        f"instructions/s ({LANES_PER_SM} per SM a clock)")
    card = f"[{smi}]"

    def bound(pairs, nbytes):
        """The least time (ms) for ``pairs`` (query, valid target) pairs and
        ``nbytes`` of inputs read once and outputs written once, and which
        of the two bounds it."""
        t_ops, t_bytes = INSTR_PER_PAIR * pairs / instr_rate, nbytes / H100_BYTES
        return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    phase("1b RANSAC draws: the JAX key chain on the card, against the CPU and jax.random's own words")
    from rivslam_tpu_torch.core import prng

    root = os.path.dirname(os.path.abspath(__file__))
    jax_runs = np.load(os.path.join(root, JAX_RUNS))
    _, subkeys = prng.split_chain(prng.key(ENGINE_SEED), len(GOLDEN_DRAWS))
    say(f"engine seed {ENGINE_SEED}: frames 0-{len(subkeys) - 1}'s subkeys {subkeys}")
    check(subkeys == [g[0] for g in GOLDEN_DRAWS], "the port's key chain is not jax.random's")
    draw_shape = (128, ENGINE_CAPACITY)  # the floor's hypotheses x capacity; REVE's are its first rows
    rows, cols = [i for i, _ in GOLDEN_AT], [j for _, j in GOLDEN_AT]
    for dt, col, bits in ((torch.float32, 1, torch.int32), (torch.float64, 2, torch.int64)):
        on_card = prng.uniform_stack(subkeys, draw_shape, dt, dev)
        one = prng.uniform(subkeys[0], draw_shape, dt, dev)
        on_cpu = prng.uniform_stack(subkeys, draw_shape, dt, "cpu")
        same = torch.equal(on_card.cpu().view(bits), on_cpu.view(bits))
        same_one = torch.equal(one.cpu().view(bits), on_cpu[0].view(bits))
        golden = np.array([[float.fromhex(h) for h in g[col]] for g in GOLDEN_DRAWS])
        got = on_card.cpu().numpy()[:, rows, cols]
        say(f"uniform {dt} {tuple(draw_shape)} of frames 0-2's subkeys: card vs CPU "
            f"{'bitwise equal' if same and same_one else 'DIFFER'}; at {GOLDEN_AT} "
            f"{'equal to' if np.array_equal(got, golden) else 'NOT'} jax.random's ({got[0].tolist()})")
        check(same and same_one, f"the card's {dt} draw differs from the CPU's")
        check(np.array_equal(got, golden), f"the {dt} draw differs from jax.random's")
        del on_card, one, on_cpu
    # one frame's draw: the host's time to issue it, and the card's
    enqueue, synced = [], []
    for _ in range(3):
        prng.uniform(subkeys[0], draw_shape, torch.float32, dev)
    torch.cuda.synchronize()
    for _ in range(50):
        t0 = time.perf_counter()
        prng.uniform(subkeys[0], draw_shape, torch.float32, dev)
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        synced.append(time.perf_counter() - t0)
    draw_dev_ms = time_ms(lambda: prng.uniform(subkeys[0], draw_shape, torch.float32, dev), 50)
    say(f"one frame's draw (float32 {draw_shape}, eager): host {1e3 * np.median(enqueue):.4f} ms to issue, "
        f"{1e3 * np.median(synced):.4f} ms to the end of its work (medians of 50); the card "
        f"{draw_dev_ms:.4f} ms {card}")
    # what a frame's draw cost before: torch.rand of both shapes on the host, each copied to the card
    gen, old = torch.Generator().manual_seed(ENGINE_SEED), []
    for _ in range(50):
        t0 = time.perf_counter()
        for rows_ in (3, draw_shape[0]):
            torch.rand((rows_, draw_shape[1]), generator=gen).to(dev)
        old.append(time.perf_counter() - t0)
    say(f"the torch.Generator draw it replaces (host torch.rand of [3, n] and [128, n], two copies): host "
        f"{1e3 * np.median(old):.4f} ms a frame (median of 50) {card}")

    phase("2 build")
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:  # one nvcc per source, started together
        builds = {name: pool.submit(mod.build) for name, mod in (
            ("K1", nn_gather), ("K2", nn_corr), ("K3", nn_argmin), ("window solve", window))}
        builds = {name: fut.result() for name, fut in builds.items()}
    for name, built in builds.items():
        say(f"{name}: nvcc built {os.path.relpath(built.path)} in {built.seconds:.2f} s")
        for ln in built.ptxas:
            say(f"  {ln}")
        if name == "window solve":
            continue
        loops = sass_scan_loops(built.path)
        if loops is None:
            say(f"{name}: no cuobjdump in this toolkit; scan loops not read")
            continue
        for fn, c in loops.items():
            per = {k: round(c[k] / c["pairs"], 3) for k in ("total", "arith", "compare", "select", "shared")}
            say(f"{name} scan loop of {fn[-60:]}: {c['total']} instructions for {c['pairs']:g} pairs; "
                f"per pair {per} (FFMA in the loop: {c['ffma']}); the bound counts {INSTR_PER_PAIR}")

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
    k1_err, _, _, cnt = compare_k1("main-path inputs", nn_gather, *k1_args)
    tied, valid_q = cnt >= 2, src_mask.bool()
    say(f"exact ties in the main path's inputs (the twin's arithmetic, B={B}): "
        f"{int(tied.sum())} of {cnt.numel()} queries tie ({int((tied & valid_q).sum())} of "
        f"{int(valid_q.sum())} valid source points; share {tied.float().mean().item():.3e}), "
        f"ties of 3 or more {int((cnt >= 3).sum())}, largest tie {int(cnt.max())}")
    k1_err = max(k1_err, k1_cases(nn_gather, dev))
    # each of the two block shapes on the main path's inputs and on the
    # cases: the wrapper picks 128x2 at B=256 and 64x1 for the small ones
    check(nn_gather.variant_for(B, CAPACITY, dev) == nn_gather.BATCH_VARIANT
          and nn_gather.variant_for(1, CAPACITY, dev) == nn_gather.SINGLE_VARIANT,
          "K1: variant_for does not pick 128x2 at B=256 and 64x1 at B=1")
    k1_err = max(k1_err, k1_cases(nn_gather, dev, nn_gather.BATCH_VARIANT),
                 compare_k1("main-path inputs", nn_gather, *k1_args, variant=nn_gather.SINGLE_VARIANT)[0])

    # K1 at the scan-to-map shape (B=1, N=1024, M=5120), on the submap of
    # the garden preset's first frames, ties across every 1024-ref tile edge
    t0 = time.perf_counter()
    garden_seq, _ = synthetic.simulate_sequence(**GARDEN_COURSE)
    garden_gt = np.linalg.inv(garden_seq.gt_poses[0]) @ garden_seq.gt_poses
    say(f"garden course: {garden_seq.num_frames} frames, simulated in {time.perf_counter() - t0:.2f} s")
    g_eng = pipeline.Engine(garden_cfg(presets), seed=ENGINE_SEED, device=dev)
    datasets.replay(g_eng, frames(garden_seq, 0, GARDEN_HEAD), ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
    k1_s2m, s2m_ties = submap_k1_inputs(g_eng, SENTINEL, dev)
    del g_eng
    say(f"scan-to-map submap after {GARDEN_HEAD} garden frames: {int(k1_s2m[2].sum())} valid refs of "
        f"{k1_s2m[1].shape[1]}; ties injected at (query, below, above) {s2m_ties}")
    k1_s2m_err, _, g_s2m, cnt_s2m = compare_k1("scan-to-map submap, ties across the tile edges", nn_gather, *k1_s2m)
    f_s2m = k1_s2m[3][0]
    for qi, lo, hi in s2m_ties:
        check(int(cnt_s2m[0, qi]) == 2 and torch.equal(g_s2m[0, :, qi], (f_s2m[:, lo] + f_s2m[:, hi]) / 2.0),
              f"K1 scan-to-map: the tie of refs {lo} and {hi} across a tile edge is not averaged")
    check(len(s2m_ties) == k1_s2m[1].shape[1] // 1024 - 1, "K1 scan-to-map: a tile edge without a tie")
    k1_err = max(k1_err, k1_s2m_err)

    phase("5 main path")
    results, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for cov in ("KNN", "RBF"):
        cfg = dataclasses.replace(cfg_on, covariance_method=cov)
        before = nn_gather.fused_gather.launches
        res = run_main(apdgicp, cfg, data, guess, dev)
        torch.cuda.synchronize()
        launches[cov] = nn_gather.fused_gather.launches - before
        results[cov] = res
    total_launches = nn_gather.fused_gather.launches
    say(f"scan-match path launches: {read_counts()}")
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
    bound_ms, bound_by = bound(pairs, k1_bytes)
    per_batch = launches["KNN"]
    say(f"K1 {k1_ms:.4f} ms/launch, plain twin {plain_ms:.4f} ms, flag-off step "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {INSTR_PER_PAIR * pairs:.3e} "
        f"instructions, {k1_bytes:.3e} bytes) at B,N,M,F={Bk},{N},{M},{F} {card}")
    say(f"K1 launches per batch of {B} scan matches: KNN {launches['KNN']}, RBF {launches['RBF']} "
        f"({per_batch / B:.3f} per frame)")

    phase("7 K2 against its plain twin")
    cfg_x = RegistrationConfig(use_fast_path=False)
    tgt_x = apdgicp.prepare(tgt_xyz, tgt_mask, cfg_x, device=dev)
    k2_err = compare_k2("exact-path inputs (B=256)", nn_corr, *exact_corr_inputs(tgt_x, src_xyz))[0]
    k2_err = max(k2_err, k2_cases(nn_corr, dev))
    splits = {b: nn_argmin.split_for(b, CAPACITY, dev) for b in (B, 1)}
    say(f"split_for: S={splits[B]} at B={B}, S={splits[1]} at B=1 (N={CAPACITY}, {sms} SMs)")
    check(splits[B] == 1 and splits[1] > 1, "split_for must not split at B=256 and must at B=1")
    k2_err = max(k2_err, k2_split_cases(nn_corr, nn_argmin, dev))

    phase("8 exact scan match")
    exact_runs = {"FAST_APDGICP KNN": dict(method="FAST_APDGICP", covariance_method="KNN"),
                  "FAST_APDGICP RBF": dict(method="FAST_APDGICP", covariance_method="RBF"),
                  "GICP": dict(method="GICP"), "ICP": dict(method="ICP")}
    for name, kw in exact_runs.items():
        cfg = RegistrationConfig(use_fast_path=False, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zero_counts()
        res = run_main(apdgicp, cfg, data, guess, dev)
        torch.cuda.synchronize()
        n = read_counts()
        secs = time.perf_counter() - t0
        T = res.T.cpu().numpy()
        check(np.isfinite(T).all() and T.shape == (B, 4, 4), f"exact {name}: bad T")
        conv = res.converged.float().mean().item()
        terr = np.linalg.norm(T[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
        say(f"exact {name}: launches {n}, converged {conv:.4f}, mean iterations "
            f"{res.iterations.float().mean().item():.2f}, median translation error "
            f"{np.median(terr):.4f} m; {secs:.3f} s for prepare + register of {B} pairs {card}")
        check(n["K2"] > 0 and n["K1"] == 0, f"exact {name}: K2 not launched (or K1 was)")
        check(conv >= MIN_CONVERGED, f"exact {name}: converged {conv} < {MIN_CONVERGED}")
        check(np.median(terr) <= MAX_MEDIAN_TERR_M, f"exact {name}: median error {np.median(terr)} m")
    # a small input on the card against the same run on the CPU
    _, args = rivslam_tpu_torch.entry(device=dev)
    got = {}
    for where in (dev, "cpu"):
        a = [x.to(where) for x in args]
        got[str(where)] = apdgicp.prepare_and_register(*a, cfg_x, device=where)
    g_, c_ = got[str(dev)], got["cpu"]
    dT = (g_.T.cpu() - c_.T).abs().max().item()
    say(f"exact entry() pair: card vs CPU max|dT| {dT:.2e}, correspondences "
        f"{int(g_.num_correspondences)} vs {int(c_.num_correspondences)}")
    check(dT <= 1e-3, f"exact entry(): card and CPU differ by {dT}")
    check(int(g_.num_correspondences) == int(c_.num_correspondences),
          "exact entry(): correspondence counts differ")

    t0 = time.perf_counter()
    seq, _ = synthetic.simulate_sequence(**COURSE)
    n_frames = seq.num_frames
    gt = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses
    say(f"cp course: {n_frames} frames, {len(seq.imu_stamps)} IMU samples, simulated in "
        f"{time.perf_counter() - t0:.2f} s")

    def drive_engine(key, cfg, seed=ENGINE_SEED, course=None, hold=True, after_frame=None):
        """One run over ``course`` ((sequence, ground truth), the cp course
        by default), the launch counts zeroed just before and read just
        after; with ``hold``, checks the ATE, corrected and not, against the
        JAX engine's for the same seed. ``after_frame(eng)`` runs after each
        frame (a drain of the loop worker). The Engine captures the
        preintegration's and the registration's CUDA graphs on the first
        frames (a capture leaves the launch counts as it found them, and
        each replay adds its captured launches); the window solve is one
        kernel launch a frame, its outer iterations and lambda tries
        counted by the Engine's solver."""
        seq_, gt_ = course if course is not None else (seq, gt)
        n_frames = seq_.num_frames
        eng = pipeline.Engine(cfg, seed=seed, device=dev)
        graphs, reg = eng.graphs, eng.reg_graphs

        def graph_counts():
            return {"preintegrate": graphs.preintegrate.replays, "window solve": graphs.solve.replays,
                    "window iterations": graphs.solve.iterations, "window tries": graphs.solve.tries,
                    "registration": reg.replays, "registration host reads": reg.reads}

        replays0 = graph_counts()
        events, wall = [torch.cuda.Event(enable_timing=True)], []

        def tick(i, n):  # replay calls this after each frame; process_frame has synced
            if after_frame is not None:
                after_frame(eng)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            wall.append(time.perf_counter())

        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        wall.append(time.perf_counter())
        events[0].record()
        outs = datasets.replay(eng, seq_, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY, progress=tick)
        torch.cuda.synchronize()
        n = read_counts()
        replays = {k: v - replays0[k] for k, v in graph_counts().items()}
        engine_s = wall[-1] - wall[0]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        wall_ms = np.diff(wall) * 1e3
        ev_ms = np.array([a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])])
        run = key.split()[0]
        ref = REF[run][seed]
        ates, digest, positions = {}, hashlib.sha256(), {}
        for corrected in (True, False):
            ts, poses = eng.trajectory(corrected=corrected)
            check(poses.shape == (n_frames, 4, 4) and np.isfinite(poses).all(),
                  f"engine {key}: non-finite poses")
            g = gt_[[int(np.argmin(np.abs(seq_.gt_stamps - t))) for t in ts]]
            ates[corrected] = ate.ate(poses[:, :3, 3], g[:, :3, 3])["rmse"]
            digest.update(np.ascontiguousarray(poses).tobytes())
            positions["corrected" if corrected else "uncorrected"] = poses[:, :3, 3]
        n_kf = sum(o["is_keyframe"] for o in outs)
        conv = float(np.mean([o["registration_ok"] for o in outs[1:]]))
        loops = eng.loop_stats["accepted"]
        loop_frames = [i for i, o in enumerate(outs) if o["loop_found"]]
        key = f"{key} seed {seed}"
        say(f"engine {key}: {n_frames} frames in {engine_s:.2f} s = {n_frames / engine_s:.2f} frames/s; "
            f"full ATE {ates[True]:.4f} m loop-corrected (JAX engine on the CPU: {ref['ate_m']:.4f} m), "
            f"{ates[False]:.4f} m uncorrected (JAX: {ref['uncorrected_ate_m']:.4f} m), limit "
            f"{MAX_ATE_RATIO}x; keyframes {n_kf} (JAX: {ref['keyframes']}); loops closed {loops} at "
            f"frames {loop_frames} (JAX: {ref['loops']}); converged share {conv:.4f}")
        say(f"engine {key}: loop_stats {json.dumps(eng.loop_stats)}; sha256 of the corrected and "
            f"uncorrected trajectories {digest.hexdigest()[:16]} (equal digests: bitwise equal runs)")
        say(f"engine {key}: launches, counted through the graph replays {n} (per frame: "
            f"{ {k: round(v / n_frames, 3) for k, v in n.items()} }); CUDA graph replays, the window "
            f"kernel's launches, iterations and tries, and the registration's host reads {replays} (per frame: "
            f"{ {k: round(v / n_frames, 3) for k, v in replays.items()} })")
        for name, v in (("wall clock", wall_ms), ("CUDA events", ev_ms)):
            say(f"engine {key}: per-frame latency by {name} over frames 1..{n_frames - 1}: median "
                f"{np.median(v[1:]):.3f} ms, p95 {np.percentile(v[1:], 95):.3f} ms, max "
                f"{v[1:].max():.3f} ms; frame 0 {v[0]:.3f} ms {card}")
        timers = {k: round(v["median_ms"], 3) for k, v in eng.timers.summary().items()}
        say(f"engine {key}: host stage medians (ms, Engine.timers) {timers}; graph solves "
            f"{eng.timers.summary().get('graph_opt', {}).get('count', 0)}")
        say(f"engine {key}: peak device memory {peak_gib:.3f} GiB {card}")
        gap = None
        if course is None and (run in CPU_GAP_M or run == "loop-off"):  # the same seed's JAX run
            name, tags = jax_run_name(run, seed)
            gap = jax_gap(jax_runs, name, {t: positions[t] for t in tags}, [o["is_keyframe"] for o in outs],
                          loop_frames if "corrected" in tags else None,
                          [-1 if o["status"] is None else o["status"]["num_correspondences"] for o in outs])
            say(f"engine {key}: against the JAX engine's run {name} (CPU float32), per-frame position gap "
                f"{json.dumps(gap)}; limit {max_gap_m(run):.4f} m")
        if hold:
            check(ates[True] <= MAX_ATE_RATIO * ref["ate_m"],
                  f"engine {key}: ATE {ates[True]} m > {MAX_ATE_RATIO} x {ref['ate_m']} m")
            check(ates[False] <= MAX_ATE_RATIO * ref["uncorrected_ate_m"],
                  f"engine {key}: uncorrected ATE {ates[False]} m > {MAX_ATE_RATIO} x {ref['uncorrected_ate_m']} m")
            for t in positions if gap is not None else ():
                if t in gap:
                    check(gap[t]["max_m"] <= max_gap_m(run),
                          f"engine {key}: {t} positions {gap[t]['max_m']} m off the JAX run's > {max_gap_m(run)} m")
        return eng, outs, n, {"ate_m": ates[True], "uncorrected_ate_m": ates[False], "keyframes": n_kf,
                              "loops": loops, "median_ms": float(np.median(wall_ms[1:])), "jax_gap": gap,
                              "wall_ms": wall_ms[1:], "digest": digest.hexdigest(), "peak_gib": peak_gib,
                              "engine_s": engine_s}

    phase("9 engine: the cp preset as shipped, loop closure on, engine seeds "
          + ", ".join(map(str, ENGINE_SEEDS)))
    seeds, held = {}, []

    def hold_backend(e):  # the window backend after each frame (backend_step builds new tensors)
        held[:] = held[-1:] + [e.state.backend]

    for seed in ENGINE_SEEDS:
        e, o, counts, seeds[seed] = drive_engine("preset", preset_cfg(presets), seed,
                                                 after_frame=hold_backend if seed == ENGINE_SEED else None)
        check(e.loop_stats["accepted"] >= 1, f"engine preset seed {seed}: no loop closed")
        check(counts["K1"] > 0 and counts["K3"] > 0, f"engine preset seed {seed}: K1 or K3 never launched")
        check(counts["window"] == n_frames,
              f"engine preset seed {seed}: {counts['window']} window kernel launches over {n_frames} frames")
        if seed == ENGINE_SEED:
            eng, outs, eng_counts = e, o, counts
    # the frame's draw as the Engine issues it on the card: one CUDA graph replay a frame
    draws = eng._draw_graphs[ENGINE_CAPACITY]
    frame_draws = draws.replays
    same = all(torch.equal(eng._frame_draw(k, draw_shape).cpu().view(torch.int32),
                           prng.uniform(k, draw_shape).view(torch.int32)) for k in subkeys)
    issue = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._frame_draw(subkeys[0], draw_shape)
        issue.append(time.perf_counter() - t0)
    say(f"engine preset seed {ENGINE_SEED}: the RANSAC draw's CUDA graph, {frame_draws} replays over "
        f"{n_frames} frames; frames 0-2's draws bitwise the CPU's: {same}; host "
        f"{1e3 * np.median(issue):.4f} ms to issue a frame's draw (median of 50; eager: phase 1b) {card}")
    check(same, "the Engine's graphed draw differs from the CPU's")
    check(frame_draws == n_frames, "the Engine did not draw once a frame")
    for k in ("ate_m", "uncorrected_ate_m", "keyframes", "loops", "median_ms"):
        port = [seeds[sd][k] for sd in ENGINE_SEEDS]
        jax_ = [REF["preset"][sd][k] for sd in ENGINE_SEEDS] if k != "median_ms" else None
        say(f"engine preset over seeds {list(ENGINE_SEEDS)}: {k} port {port} (mean {np.mean(port):.4f})"
            + (f", JAX engine on the CPU {jax_} (mean {np.mean(jax_):.4f})" if jax_ else f" {card}"))

    # the first frames of the loop-off path on the card and on the CPU,
    # float32 and float64, same seed and therefore the same RANSAC draws
    head = frames(seq, 0, CPU_FRAMES)
    runs = {}
    for key, where, dt in (("card", dev, torch.float32), ("cpu32", "cpu", torch.float32),
                           ("cpu64", "cpu", torch.float64)):
        e = pipeline.Engine(loop_off_cfg(presets), dtype=dt, seed=ENGINE_SEED, device=where)
        runs[key] = datasets.replay(e, head, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
    card_p, cpu32, cpu64 = (np.stack([x["pose"] for x in runs[k]]) for k in ("card", "cpu32", "cpu64"))
    gap, band = np.abs(card_p - cpu32).max(), np.abs(cpu32 - cpu64).max()
    same_kf = [x["is_keyframe"] for x in runs["card"]] == [x["is_keyframe"] for x in runs["cpu32"]]
    tol = CPU_BAND_FACTOR * band + CPU_BAND_FLOOR_M
    say(f"loop-off path, first {CPU_FRAMES} frames, card vs CPU float32: largest pose gap {gap:.3e} "
        f"(CPU float32 vs float64: {band:.3e}; tolerance {tol:.3e}); is_keyframe flags "
        f"{'equal' if same_kf else 'differ'}")
    check(gap <= tol, f"card and CPU differ by {gap} > {tol}")

    phase("10 engine: exact registration (use_fast_path=False)")
    eng_x, _, exact_counts, _ = drive_engine("exact", exact_cfg())
    check(exact_counts["K2"] > 0, "engine exact: K2 never launched")

    phase("11 K3 against its plain twin")
    bk = eng.state.backend  # the last frame's fitness inputs (backend/slam.py)
    rel = lie.se3_matrix(bk.odom_R[-1].T @ bk.odom_R[-2], bk.odom_R[-1].T @ (bk.odom_p[-2] - bk.odom_p[-1]))
    q3 = lie.transform_points(rel, bk.xyz[-2])[None].contiguous()
    r3 = torch.where(bk.cloud_mask[-1][:, None], bk.xyz[-1], SENTINEL)[None].contiguous()
    m3 = bk.cloud_mask[-1][None].contiguous()
    k3_err = compare_k3("engine inputs", nn_argmin, q3, r3, m3)[0]
    k3_err = max(k3_err, k3_cases(nn_argmin, dev), k3_split_cases(nn_argmin, dev))
    # K2 on the exact engine's own last correspondence step: the odometry
    # keyframe as target, the last keyframe cloud as query
    xs = eng_x.state
    k2_eng = exact_corr_inputs(apdgicp._map(xs.odo.target, lambda t_: t_[None]), xs.kf_clouds[-1][0][None])
    k2_err = max(k2_err, compare_k2("exact engine inputs", nn_corr, *k2_eng)[0])

    # K1 at the preset engine's registration shape: the odometry keyframe
    # as target, the last keyframe cloud as query (B=1, N=M=1024, F=9)
    ps = eng.state
    tgt1 = apdgicp._map(ps.odo.target, lambda t_: t_[None])
    c1 = tgt1.cov
    k1_eng = (ps.kf_clouds[-1][0][None].contiguous(),
              torch.where(tgt1.mask[..., None], tgt1.xyz, SENTINEL).contiguous(),
              tgt1.mask.contiguous(),
              torch.stack(list(tgt1.xyz.unbind(-1)) + [c1[..., 0, 0], c1[..., 0, 1], c1[..., 0, 2],
                                                      c1[..., 1, 1], c1[..., 1, 2], c1[..., 2, 2]],
                          dim=1).contiguous())
    k1_err = max(k1_err, compare_k1("preset engine inputs", nn_gather, *k1_eng)[0])

    phase("12 K1, K2 and K3 timing")

    def k3_library(q, r, m):  # bmm + norms + masked argmin: the plain-torch composition
        d2 = (q * q).sum(-1)[..., None] + (r * r).sum(-1)[:, None, :] - 2.0 * torch.bmm(q, r.transpose(1, 2))
        d2 = torch.where(m[:, None, :], d2, torch.inf)
        idx = torch.argmin(d2, dim=-1)
        return idx, torch.take_along_dim(d2, idx[..., None], dim=-1)

    def k2_library(q, r, m, f):  # ... and a take_along_dim gather of the winner's row
        idx, d2 = k3_library(q, r, m)
        return idx, d2, torch.take_along_dim(f, idx[..., None], dim=1)

    def k1_library(q, r, m, f_t):  # the flag-off correspondence step: bmm + argmin + gather
        d2 = (q * q).sum(-1)[..., None] + (r * r).sum(-1)[:, None, :] - 2.0 * torch.bmm(q, r.transpose(1, 2))
        idx = torch.argmin(d2, dim=-1)
        best = torch.take_along_dim(d2, idx[..., None], dim=-1)
        return best, torch.gather(f_t, 2, idx[:, None, :].expand(-1, f_t.shape[1], -1))

    def timed(name, kernel, plain, library, q, r, m, f_bytes, reps):
        """One kernel on one input set: ms per launch, plain twin, library
        composition, the bound from this run's inputs. A single problem
        (B=1) is timed inside a CUDA graph: back-to-back host launches of a
        ~10 us kernel would time the host. Its host-launched time, three
        rounds, is printed beside it: the backend launches K3 from the host,
        and loop verification K1 or K2 (the odometry replays them in its
        graphs); host-launched times move 2-3x between calls."""
        Bq, Nq, Mq = q.shape[0], q.shape[1], r.shape[1]
        small = Bq == 1
        ms = time_ms(kernel, reps=reps, warmup=3, graph=small)
        host = ("; host-launched " + " / ".join(f"{time_ms(kernel, reps=reps, warmup=3):.4f}" for _ in range(3))
                + " ms/launch" if small else "")
        pms = time_ms(plain, reps=5, graph=small)
        lms = time_ms(library, reps=reps, warmup=3, graph=small)
        pairs = Nq * int(m.sum().item())  # every query against every valid ref
        nbytes = 4 * (Bq * Nq * 3 + Bq * Mq * 3 + 2 * Bq * Nq) + Bq * Mq + f_bytes
        bms, by = bound(pairs, nbytes)
        say(f"{name} (B,N,M={Bq},{Nq},{Mq}{'; device time in a CUDA graph' if small else ''}): "
            f"{ms:.4f} ms/launch = {bms / ms:.1%} of its bound "
            f"{bms:.5f} ms ({by}: {INSTR_PER_PAIR * pairs:.3e} instructions, {nbytes:.3e} bytes); "
            f"plain twin {pms:.4f} ms; library composition {lms:.4f} ms{host} {card}")
        return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": lms}

    rng = np.random.default_rng(9)
    qb = torch.as_tensor(rng.normal(size=(256, 1024, 3)) * 10, dtype=torch.float32, device=dev)
    rb = torch.as_tensor(rng.normal(size=(256, 1024, 3)) * 10, dtype=torch.float32, device=dev)
    mb = torch.ones((256, 1024), dtype=torch.bool, device=dev)
    fb_t = torch.as_tensor(rng.normal(size=(256, 9, 1024)), dtype=torch.float32, device=dev)
    # the same inputs for all three kernels: K1 gathers [B, F, M] features,
    # K2 the same features as [B, M, F] rows, K3 none
    sets = {"scan-match pairs": (k1_args, 20), "random clouds": ((qb, rb, mb, fb_t), 20),
            "preset engine (B=1)": (k1_eng, 200)}
    timing = {}
    for sname, ((q, r, m, f_t), reps) in sets.items():
        f_rows = f_t.transpose(1, 2).contiguous()
        Fq = f_t.shape[1]
        fbytes = 4 * Fq * (r.shape[0] * r.shape[1] + q.shape[0] * q.shape[1])
        timing[("K1", sname)] = timed(
            f"K1 on {sname}", lambda: nn_gather.fused_gather(q, r, m, f_t),
            lambda: nn_gather.fused_gather_plain(q, r, m, f_t), lambda: k1_library(q, r, m, f_t),
            q, r, m, fbytes, reps)
        timing[("K2", sname)] = timed(
            f"K2 on {sname}", lambda: nn_corr.fused_correspondence(q, r, m, f_rows),
            lambda: nn_corr.fused_correspondence_plain(q, r, m, f_rows),
            lambda: k2_library(q, r, m, f_rows), q, r, m, fbytes + 4 * q.shape[0] * q.shape[1], reps)
        timing[("K3", sname)] = timed(
            f"K3 on {sname}", lambda: nn_argmin.nearest_neighbor(q, r, m),
            lambda: nn_argmin.nearest_neighbor_plain(q, r, m), lambda: k3_library(q, r, m),
            q, r, m, 0, reps)
        say(f"on {sname}: K1/K2 {timing[('K1', sname)]['ms'] / timing[('K2', sname)]['ms']:.3f}, "
            f"K1/K3 {timing[('K1', sname)]['ms'] / timing[('K3', sname)]['ms']:.3f}")
    q, r, m, f = k2_eng
    k2 = timed("K2 at the exact engine's shape (F=12)", lambda: nn_corr.fused_correspondence(q, r, m, f),
               lambda: nn_corr.fused_correspondence_plain(q, r, m, f), lambda: k2_library(q, r, m, f),
               q, r, m, 4 * f.shape[2] * (r.shape[1] + q.shape[1]) + 4 * q.shape[1], 200)
    k3 = timed("K3 at the engine's fitness inputs", lambda: nn_argmin.nearest_neighbor(q3, r3, m3),
               lambda: nn_argmin.nearest_neighbor_plain(q3, r3, m3), lambda: k3_library(q3, r3, m3),
               q3, r3, m3, 0, 200)
    k1 = timing[("K1", "preset engine (B=1)")]

    # the A/B of K1's two block shapes, in turns (a, b, b, a), on the
    # scan-match pairs and at the engine's shape: the choice of variant_for
    variants = (nn_gather.BATCH_VARIANT, nn_gather.SINGLE_VARIANT)
    for sname in ("scan-match pairs", "preset engine (B=1)"):
        (q, r, m, f_t), reps = sets[sname]
        got = {}
        for v in variants + variants[::-1]:
            got.setdefault(v, []).append(
                time_ms(lambda: nn_gather._launch(q, r, m, f_t, v), reps=reps, warmup=2,
                        graph=q.shape[0] == 1))
        for v, t in got.items():
            port = v == nn_gather.variant_for(q.shape[0], q.shape[1], q.device)
            say(f"K1 A/B on {sname}: {v.name}{' (launched by the port)' if port else ''}: "
                f"{t[0]:.4f} / {t[1]:.4f} ms, mean {np.mean(t):.4f} ms {card}")

    # K2 and K3 on the engine's inputs at every split S, as device time in a
    # CUDA graph, beside the floor: an empty kernel on the same grid and
    # clusters in a graph
    floor_lib = nn_argmin.build().lib
    floors = {}
    for S in range(1, nn_argmin.MAX_SPLIT + 1):
        floors[S] = time_ms(lambda: cuda_build.launch(floor_lib.rivslam_nn_empty, dev, 1, CAPACITY, S),
                            reps=200, warmup=3, graph=True)
        k3_s = time_ms(lambda: nn_argmin._launch(q3, r3, m3, S), reps=200, warmup=3, graph=True)
        k2_s = time_ms(lambda: nn_corr._launch(*k2_eng, S), reps=200, warmup=3, graph=True)
        say(f"split S={S}{' (split_for at B=1)' if S == splits[1] else ''}: empty-kernel floor "
            f"{floors[S]:.4f} ms; K3 {k3_s:.4f} ms; K2 {k2_s:.4f} ms (engine inputs, B=1, "
            f"N=M={CAPACITY}, device time in a CUDA graph) {card}")

    q, r, m, f_t = k1_s2m
    k1_s2m_t = timed("K1 at the scan-to-map shape (garden submap)", lambda: nn_gather.fused_gather(q, r, m, f_t),
                     lambda: nn_gather.fused_gather_plain(q, r, m, f_t), lambda: k1_library(q, r, m, f_t),
                     q, r, m, 4 * f_t.shape[1] * (r.shape[1] + q.shape[1]), 200)
    say(f"K1 at the scan-to-map shape against K1 at the preset engine's B=1 (M=1024): "
        f"{k1_s2m_t['ms'] / k1['ms']:.2f}x")

    say(f"launches per frame: preset engine K1 {eng_counts['K1'] / n_frames:.3f}, K3 "
        f"{eng_counts['K3'] / n_frames:.3f}; exact engine K2 {exact_counts['K2'] / n_frames:.3f}, "
        f"K3 {exact_counts['K3'] / n_frames:.3f}")
    phase("12b the window solve: csrc/window_lm.cu on the newest window of phase 9's run, beside its twin "
          "and its floor")

    def on(obj, where):
        return type(obj)(**{fl.name: on(getattr(obj, fl.name), where) if dataclasses.is_dataclass(getattr(obj, fl.name))
                            else getattr(obj, fl.name).to(where) for fl in dataclasses.fields(obj)})

    def factor_flops(W):  # one damped solve: the banded Cholesky and the two triangular solves
        N, fl = 15 * W, 0
        for j in range(N):
            m = min(N - 1, 15 * (j // 15 + 2) - 1) - j  # rows below j reaching column j
            fl += 1 + m + m * (m + 1) + 2 * (2 * m + 1)
        return fl

    # the window that the run's last backend_step handed its solver, rebuilt from the backend
    # state before that frame and after it: backend_step rolls the window, puts the IMU
    # prediction from the optimized navstate before it in the new slot, and builds the factors
    # from the rolled state (slam.window_factors), of which the solve changes only ``nav``
    before, after = held
    bk, bias = eng.cfg.backend, slam.bias_information(eng.cfg.imu)
    p_int = pre.Preintegration(*(a[-1] for a in after.preint.astuple()))
    pred = pre.predict(NavState(before.stamps[-1], *(a[-1] for a in before.nav.astuple())), p_int,
                       eng.cfg.imu.gravity)
    x0 = window.WindowState(*(torch.cat([a[1:], b[None]]) for a, b in
                              zip(before.nav.astuple(), (pred.R, pred.p, pred.v, pred.bg, pred.ba))))
    f = slam.window_factors(dataclasses.replace(after, nav=x0))
    params = window._params(bk, bias, torch.float32)
    xb, fb = window._lead1(x0), window._lead1(f)
    xk, chi2_k, counts = window.solve_batched(xb, fb, bk, bias, params)
    it, tries = counts[0].tolist()
    check(torch.equal(xk.R[0], after.nav.R), "window solve: the rebuilt window is not the one the Engine solved")
    # against the twin on the CPU, within the limits of the card tests (twin_limits: three
    # times the twin's own spread on this window, or WINDOW_TOL, whichever is larger)
    x_cpu, f_cpu = on(x0, "cpu"), on(f, "cpu")
    xt, chi2_t, it_t, tries_t = window.solve_window(x_cpu, f_cpu, bk, bias)
    win_err = max(float((a[0].cpu() - b).abs().max()) for a, b in zip(xk.astuple(), xt.astuple()))
    chi2_gap = abs(float(chi2_k[0]) - float(chi2_t)) / max(abs(float(chi2_t)), 1e-30)
    tol_x, tol_c = twin_limits(x_cpu, f_cpu, bk, bias)
    win_ms = time_ms(lambda: window.solve_batched(xb, fb, bk, bias, params), reps=200, warmup=3)

    def host_ms(fn, reps):
        got = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            got.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(got))

    solve_ms = host_ms(lambda: window.solve(x0, f, bk, bias), 50)
    twin_ms = host_ms(lambda: window.solve_window(x0, f, bk, bias), 5)
    one = torch.zeros(1, device=dev)

    def empty_and_read():
        cuda_build.launch(floor_lib.rivslam_nn_empty, dev, 1, CAPACITY, 1)
        return one.item()

    floor_ms = host_ms(empty_and_read, 50)
    flops = tries * factor_flops(x0.window)
    ops_ms = 1e3 * flops / F32_FLOPS
    window_t = {"ms": win_ms, "plain_ms": twin_ms, "bound_ms": max(ops_ms, floor_ms),
                "bound_by": "launch and read" if floor_ms >= ops_ms else "operations", "host_ms": solve_ms}
    solver = eng.graphs.solve
    say(f"window solve over phase 9's {n_frames} frames (seed {ENGINE_SEED}): {eng_counts['window']} launches; "
        f"outer iterations {solver.iterations / solver.replays:.3f} and lambda tries "
        f"{solver.tries / solver.replays:.3f} a solve")
    say(f"window solve on its newest window (W={x0.window}, {it} iterations, {tries} tries; the twin on the CPU: "
        f"{it_t}, {tries_t}): kernel {win_ms:.4f} ms/launch (CUDA events, host-launched back to back); a whole "
        f"solve, launch and read, {solve_ms:.4f} ms (host, median of 50); the plain twin on the card "
        f"{twin_ms:.3f} ms (median of 5); bound {window_t['bound_ms']:.4f} ms ({window_t['bound_by']}: its "
        f"factorizations and solves {flops:.3e} flop = {ops_ms:.6f} ms at {F32_FLOPS:.3g} flop/s; an empty "
        f"kernel launched and one host read {floor_ms:.4f} ms); against the twin on the CPU: state "
        f"{win_err:.3e} (limit {tol_x:.3e}), chi2 {chi2_gap:.3e} relative (limit {tol_c:.3e}) {card}")
    check((it, tries) == (it_t, tries_t), "the window kernel's iterations or tries differ from its twin's")
    check(win_err <= tol_x and chi2_gap <= tol_c,
          f"the window kernel is off its twin: state {win_err} > {tol_x} or chi2 {chi2_gap} > {tol_c}")

    def latency(stats):
        w = stats["wall_ms"]
        return (f"median {np.median(w):.3f} ms, p95 {np.percentile(w, 95):.3f} ms, max {w.max():.3f} ms, "
                f"{int((w > FRAME_INTERVAL_MS).sum())} of {len(w)} frames over {FRAME_INTERVAL_MS:.0f} ms")

    def async_cfg(cfg):
        return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, async_loop=True))

    def k1_by_shape(name, eng, counts, n):
        """K1 launches at each registration shape, through the graph replays,
        and loop verification's host-launched rest; returns the replays'."""
        by_shape = eng.reg_graphs.launches_by_shape()
        graphed = sum(v.get("K1", 0) for v in by_shape.values())
        say(f"engine {name}: K1 launches by registration shape (B, N, M), through the graph replays "
            f"{ {str(k): v.get('K1', 0) for k, v in sorted(by_shape.items())} } (per frame "
            f"{ {str(k): round(v.get('K1', 0) / n, 3) for k, v in sorted(by_shape.items())} }); loop "
            f"verification, host-launched at B={eng.cfg.loop.verify_candidates}: {counts['K1'] - graphed}; "
            f"K3 {counts['K3']} ({counts['K3'] / n:.3f} a frame)")
        return by_shape

    phase("13 engine: the garden course's configuration (scan-to-map odometry), loop closure on")
    gn = garden_seq.num_frames
    # the shipped garden preset runs in profile_torch.py --digest
    name = "garden-course"
    g_eng, _, g_counts, sync = drive_engine(name, garden_course_cfg(), course=(garden_seq, garden_gt))
    check(sync["loops"] >= 1, f"engine {name}: no loop closed")
    check(g_counts["K1"] > 0 and g_counts["K3"] > 0, f"engine {name}: K1 or K3 never launched")
    by_shape = k1_by_shape(name, g_eng, g_counts, gn)
    s2m_shape = (1, ENGINE_CAPACITY, g_eng.cfg.odometry.max_submap_frames * ENGINE_CAPACITY)
    check(by_shape.get(s2m_shape, {}).get("K1", 0) > 0, f"engine {name}: K1 never launched at the "
          "scan-to-map shape")
    say(f"engine {name}: per-frame latency by wall clock {latency(sync)} {card}")
    s2m_launches = by_shape[s2m_shape]["K1"]
    del g_eng

    phase("14 async loop worker: drained (cp, against phase 9) and free-running (the garden course)")
    a_eng, _, _, drained = drive_engine("preset drained async", async_cfg(preset_cfg(presets)),
                                        after_frame=lambda e: e.drain_loops())
    worker = read_worker_counts()
    a_eng.close()
    say(f"drained async run: worker launches {worker}; loop_stats {json.dumps(a_eng.loop_stats)}; digest "
        f"{drained['digest'][:16]}, phase 9 seed {ENGINE_SEED}: {seeds[ENGINE_SEED]['digest'][:16]}")
    check(drained["digest"] == seeds[ENGINE_SEED]["digest"],
          "the drained async run's trajectories differ from the synchronous run's (phase 9)")
    check(sum(worker.values()) > 0, "drained async run: the worker launched no kernel")
    f_eng, _, f_counts, free = drive_engine("garden-course free-running async",
                                            async_cfg(garden_course_cfg()),
                                            course=(garden_seq, garden_gt), hold=False)
    worker = read_worker_counts()
    f_eng.close()
    fs = f_eng.loop_stats
    say(f"free-running async garden-course run: loops closed {free['loops']} (synchronous: {sync['loops']}), "
        f"detections {fs['detections_run']}, keyframes skipped while the worker was busy "
        f"{fs['skipped_worker_busy']} of {free['keyframes']}; launches on the frame path {f_counts}, on "
        f"the worker {worker}")
    say(f"free-running async garden-course run: ATE {free['ate_m']:.4f} m corrected, "
        f"{free['uncorrected_ate_m']:.4f} m uncorrected (synchronous: {sync['ate_m']:.4f} / "
        f"{sync['uncorrected_ate_m']:.4f} m)")
    say(f"free-running async garden-course run: per-frame latency {latency(free)}; synchronous (phase 13): "
        f"{latency(sync)} {card}")
    check(free["loops"] >= 1, "free-running async garden-course run: no loop closed")
    check(sum(worker.values()) > 0, "free-running async garden-course run: the worker launched no kernel")

    phase("15 CLI: python -m rivslam_tpu_torch --device cuda, run and resume")
    import tempfile

    from rivslam_tpu_torch.io import tum
    from rivslam_tpu_torch.runtime import native

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (root, os.environ.get("PYTHONPATH")))))
    with tempfile.TemporaryDirectory() as tmp:
        path = lambda name: os.path.join(tmp, name)
        native.write_rivbin(path("first.rivbin"), frames(garden_seq, 0, CLI_FRAMES))
        frames(garden_seq, CLI_FRAMES, 2 * CLI_FRAMES).save(path("next.npz"))
        base = [sys.executable, "-m", "rivslam_tpu_torch", "--device", "cuda", "--preset", "garden"]
        for name, args in (("run", ["--seq", path("first.rivbin"), "--async-loop", "--ckpt", path("ck"),
                                    "--out", path("first.txt")]),
                           ("resume", ["--seq", path("next.npz"), "--resume", path("ck"),
                                       "--out", path("next.txt")])):
            t0 = time.perf_counter()
            proc = subprocess.run(base + args, capture_output=True, text=True, timeout=600, cwd=root, env=env)
            check(proc.returncode == 0, f"CLI {name} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-3000:]}")
            say(f"CLI {name} ({' '.join(args[::2])}): exit 0 in {time.perf_counter() - t0:.1f} s; "
                + " | ".join(ln for ln in proc.stdout.splitlines() if ln.startswith(("wrote", "checkpoint"))))
        ts1, P1 = tum.load_tum(path("first.txt"))
        ts2, P2 = tum.load_tum(path("next.txt"))
        check(len(ts1) == CLI_FRAMES and np.isfinite(P1).all(), "CLI run: bad TUM trajectory")
        check(len(ts2) == 2 * CLI_FRAMES and np.isfinite(P2).all() and np.all(np.diff(ts2) > 0),
              "CLI resume: the TUM trajectory is not the dumped frames followed by the new ones")
        gt_ = garden_gt[[int(np.argmin(np.abs(garden_seq.gt_stamps - t))) for t in ts2]]
        say(f"CLI: resumed trajectory {len(ts2)} poses, ATE over them {ate.ate(P2[:, :3, 3], gt_[:, :3, 3])['rmse']:.4f} m; "
            f"its first {CLI_FRAMES} poses against the first run's: max gap "
            f"{np.abs(P2[:CLI_FRAMES] - P1).max():.3e}; step across the resume "
            f"{np.linalg.norm(P2[CLI_FRAMES, :3, 3] - P2[CLI_FRAMES - 1, :3, 3]):.3f} m")

    phase("16 whole-sequence replay: the cp course, loop closure off, against the process_frame loop")
    rp_cfg = loop_off_cfg(presets)
    pf_eng, _, pf_counts, pf = drive_engine("loop-off", rp_cfg)
    del pf_eng
    stacked = datasets.stack_sequence(seq, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
    rp_eng = pipeline.Engine(rp_cfg, seed=ENGINE_SEED, device=dev)
    reg = rp_eng.reg_graphs
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rep = rp_eng.replay_sequence(stacked)  # ends with its copy to the host
    first_s = time.perf_counter() - t0
    rp_counts = read_counts()
    rp_reads = reg.reads
    rp_digest = digest_of(rep["pose"])
    check(rep["pose"].shape == (n_frames, 4, 4) and np.isfinite(rep["pose"]).all(), "replay: bad poses")
    say(f"replay: {n_frames} frames in {first_s:.3f} s = {n_frames / first_s:.2f} frames/s "
        f"({1e3 * first_s / n_frames:.3f} ms a frame); the process_frame loop-off run of the same frames: "
        f"{pf['engine_s']:.3f} s = {n_frames / pf['engine_s']:.2f} frames/s, median frame {pf['median_ms']:.3f} "
        f"ms (both with their graph captures; steady state: python -m rivslam_tpu_torch.eval.latency) {card}")
    say(f"replay: launches {rp_counts} ({ {k: round(v / n_frames, 3) for k, v in rp_counts.items()} } a frame; "
        f"process_frame loop-off: {pf_counts}); registration host reads {rp_reads} "
        f"({rp_reads / n_frames:.3f} a frame); window iterations a frame "
        f"{rep['solver_iterations'][1:].mean():.3f}; keyframes {int(rep['is_keyframe'].sum())}, converged share "
        f"{rep['converged'][1:].mean():.4f}")
    say(f"replay digest {rp_digest[:16]}, process_frame loop-off digest {pf['digest'][:16]}")
    check(rp_digest == pf["digest"], "the replay's trajectory differs from the process_frame loop-off run's")
    check(rp_counts["K1"] > 0 and rp_counts["K3"] > 0, "replay: K1 or K3 never launched")
    # the host syncs of each frame step, on fresh Engines with the same seed
    # (the same draws and iterations, frame by frame; captures on frames 0-1)
    head = frames(seq, 0, SYNC_FRAMES)
    e_pf = pipeline.Engine(rp_cfg, seed=ENGINE_SEED, device=dev)
    pf_steps, pf_at, pf_all = count_syncs(
        e_pf, lambda: datasets.replay(e_pf, head, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY))
    e_rp = pipeline.Engine(rp_cfg, seed=ENGINE_SEED, device=dev)
    head_stack = datasets.stack_sequence(head, ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
    rp_steps, rp_at, rp_all = count_syncs(e_rp, lambda: e_rp.replay_sequence(head_stack))
    steady = slice(2, SYNC_FRAMES)
    per_frame = {name: (total - at[1]) / (SYNC_FRAMES - 2)
                 for name, total, at in (("replay", rp_all, rp_at), ("process_frame", pf_all, pf_at))}
    say(f"host syncs (torch.cuda.set_sync_debug_mode), frames 2..{SYNC_FRAMES - 1}: a frame step, replay mean "
        f"{np.mean(rp_steps[steady]):.2f} ({rp_steps}), process_frame mean {np.mean(pf_steps[steady]):.2f} "
        f"({pf_steps}); a frame, from the end of frame 1's step to the end of the run: replay "
        f"{per_frame['replay']:.2f} (its copy to the host at the end included), process_frame "
        f"{per_frame['process_frame']:.2f} (its outputs and the keyframe insertion included)")
    check(len(rp_steps) == len(pf_steps) == SYNC_FRAMES and all(a <= b for a, b in zip(rp_steps, pf_steps)),
          "replay: a frame step reads the host more often than process_frame's")
    del e_pf, e_rp
    # K2 on the replay's path: the exact registration, loop off, 16 frames
    x_cfg = dataclasses.replace(exact_cfg(), loop=dataclasses.replace(exact_cfg().loop, enable=False))
    x_eng = pipeline.Engine(x_cfg, seed=ENGINE_SEED, device=dev)
    x_stack = datasets.stack_sequence(frames(seq, 0, CLI_FRAMES), ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
    torch.cuda.synchronize()
    zero_counts()
    x_rep = x_eng.replay_sequence(x_stack)
    x_counts = read_counts()
    say(f"exact replay, {CLI_FRAMES} frames: launches {x_counts}; keyframes {int(x_rep['is_keyframe'].sum())}")
    check(x_counts["K2"] > 0 and x_counts["K3"] > 0 and np.isfinite(x_rep["pose"]).all(),
          "exact replay: K2 or K3 never launched, or bad poses")
    del x_eng

    phase(f"17 replay_fleet: B=2 sequences of {FLEET_FRAMES} cp frames, each against its single replay")
    fl_stacks = [datasets.stack_sequence(frames(seq, a, a + FLEET_FRAMES), ENGINE_CAPACITY, ENGINE_IMU_CAPACITY)
                 for a in (0, FLEET_FRAMES)]
    batch = {k: np.stack([st_[k] for st_ in fl_stacks]) for k in fl_stacks[0]}
    fl_eng = pipeline.Engine(rp_cfg, seed=ENGINE_SEED, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    fleet = fl_eng.replay_fleet(batch)
    fleet_s = time.perf_counter() - t0
    fl_counts = read_counts()
    fleet_digests = [digest_of(fleet["pose"][b]) for b in range(2)]
    for b in range(2):  # sequence b: the single replay of an Engine keyed fold_in(key(seed), b)
        single = pipeline.Engine(rp_cfg, device=dev)
        single.key = prng.fold_in(prng.key(ENGINE_SEED), b)
        t0 = time.perf_counter()
        one = single.replay_sequence(fl_stacks[b])
        one_s = time.perf_counter() - t0
        d_f, d_1 = digest_of(fleet["pose"][b]), digest_of(one["pose"])
        say(f"fleet sequence {b}: digest {d_f[:16]}, single replay {d_1[:16]} ({one_s:.3f} s, captures included)")
        check(d_f == d_1, f"fleet sequence {b} differs from its single replay")
        del single
    say(f"fleet B=2 x {FLEET_FRAMES} frames: {fleet_s:.3f} s (captures included) = {FLEET_FRAMES / fleet_s:.2f} "
        f"frames/s per sequence, {2 * FLEET_FRAMES / fleet_s:.2f} in all; launches {fl_counts} {card}")
    check(fl_counts["K1"] > 0 and fl_counts["K3"] > 0, "fleet: K1 or K3 never launched")
    del fl_eng

    phase("18 engine: the cp course through VGICP and NDT_OMP (validation configuration, loop closure on)")
    for key, method in (("vgicp", "VGICP"), ("ndt", "NDT_OMP")):
        v_eng, _, v_counts, v = drive_engine(key, voxel_cfg(method))
        replays = v_eng.reg_graphs.replays
        say(f"engine {key}: per-frame latency by wall clock {latency(v)}; registration graph replays "
            f"{replays} ({replays / n_frames:.3f} a frame) {card}")
        check(v_counts["K3"] > 0 and v_counts["K1"] == 0 and v_counts["K2"] == 0,
              f"engine {key}: K3 not launched, or a GICP kernel was")
        check(replays > 0, f"engine {key}: the voxel registration did not replay its CUDA graphs")
        del v_eng

    phase("19 CLI: python -m rivslam_tpu_torch --device cuda --device-replay")
    with tempfile.TemporaryDirectory() as tmp:
        path = lambda name: os.path.join(tmp, name)  # noqa: E731
        frames(seq, 0, CLI_FRAMES).save(path("cp.npz"))
        args = ["--seq", path("cp.npz"), "--device-replay", "--map", path("cp.pcd"), "--out", path("cp.txt")]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "rivslam_tpu_torch", "--device", "cuda", "--preset", "cp"]
                              + args, capture_output=True, text=True, timeout=600, cwd=root, env=env)
        check(proc.returncode == 0, f"CLI --device-replay failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
        ts_r, P_r = tum.load_tum(path("cp.txt"))
        check(len(ts_r) == CLI_FRAMES and np.isfinite(P_r).all(), "CLI --device-replay: bad TUM trajectory")
        say(f"CLI --device-replay: exit 0 in {time.perf_counter() - t0:.1f} s; "
            + " | ".join(ln for ln in (proc.stdout + proc.stderr).splitlines()
                         if ln.startswith(("wrote", "device replay"))) + f" {card}")

    phase("20 distributed layer on a NCCL world of 1")
    from rivslam_tpu_torch.dist import dist_gn, dist_graph, mesh as mesh_mod
    from rivslam_tpu_torch.eval.scaling import _drifted_loop_graph
    from rivslam_tpu_torch.frontend import replay_device
    from rivslam_tpu_torch.loop import block_schur, global_graph

    t_dist = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        say("dist: init_process_group(nccl, world 1, file:// store, 60 s timeout) ...")
        mesh_mod.init_world("nccl", 0, 1, os.path.join(tmp, "init"), timeout_s=60.0)
        say("dist: process group up")
        try:
            m = mesh_mod.make_mesh(1, 1)
            x_cfg = RegistrationConfig(use_fast_path=False)
            src8, tgt8 = (apdgicp.prepare(xyz[:8], mask[:8], x_cfg, device=dev)
                          for xyz, mask in ((src_xyz, src_mask), (tgt_xyz, tgt_mask)))
            fields = ("T", "H", "error", "converged", "iterations", "num_correspondences", "fitness")

            def same(a, b):
                return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)

            zero_counts()
            got = dist_gn.batched_register(src8, tgt8, guess[:8], x_cfg, m)
            torch.cuda.synchronize()
            c_batched = read_counts()
            want = apdgicp.register(src8, tgt8, guess[:8], x_cfg)
            check(same(got, want), "batched_register differs from register on the same batch")
            check(c_batched["K2"] > 0, "batched_register: K2 never launched")
            one = [apdgicp.PreparedCloud(xyz=c.xyz[:1], mask=c.mask[:1], cov=c.cov[:1]) for c in (src8, tgt8)]
            zero_counts()
            got = dist_gn.sharded_register(*one, guess[:1], x_cfg, m)
            torch.cuda.synchronize()
            c_sharded = read_counts()
            check(same(got, apdgicp.register(*one, guess[:1], x_cfg)), "sharded_register differs from register")
            check(c_sharded["K2"] > 0, "sharded_register: K2 never launched")
            say(f"batched_register (B=8, exact) and sharded_register (1, {CAPACITY}, {CAPACITY}) bitwise "
                f"register's; launches {c_batched} and {c_sharded}")

            F = 8
            args = [np.stack([stacked[k][:F]] * 2) for k in ("xyz", "mask")]
            args += [np.zeros((2, F, 3), np.float32), np.stack([stacked["stamps"][:F]] * 2)]
            zero_counts()
            poses, kf, conv = dist_gn.batched_replay_odometry(*args, rp_cfg.odometry, rp_cfg.registration, m,
                                                              device=dev)
            torch.cuda.synchronize()
            c_replay = read_counts()
            single = replay_device.replay_odometry(*(a[0] for a in args), rp_cfg.odometry, rp_cfg.registration,
                                                   device=dev)
            check(all(torch.equal(x[s], y) for s in range(2) for x, y in zip((poses, kf, conv), single)),
                  "batched_replay_odometry differs from replay_odometry")
            check(c_replay["K1"] > 0, "batched_replay_odometry: K1 never launched")
            say(f"batched_replay_odometry (S=2, {F} cp frames) bitwise replay_odometry's; launches {c_replay}")

            g = _drifted_loop_graph(64, 8, 56, torch.float64, dev)
            for name, sharded, local in (
                ("PCG", lambda: dist_graph.solve_pose_graph_sharded(g, m, gn_iters=6),
                 lambda: global_graph.solve_pose_graph(g, gn_iters=6)),
                ("block-Schur", lambda: block_schur.solve_pose_graph_schur_sharded(g, m, num_blocks=8, gn_iters=6),
                 lambda: block_schur.solve_pose_graph_schur(g, num_blocks=8, gn_iters=6)),
            ):
                (gs, c2s), (gl, c2l) = sharded(), local()
                dp = (gs.p - gl.p).abs().max().item()
                rel = abs(float(c2s) - float(c2l)) / abs(float(c2l))
                say(f"sharded {name}: chi2 {float(c2s):.10g} against the local {float(c2l):.10g} (relative "
                    f"{rel:.2e}), max|dp| {dp:.2e} m")
                check(dp <= 1e-6 and rel <= 1e-6, f"sharded {name} differs from its local twin")

            fm_eng = pipeline.Engine(rp_cfg, seed=ENGINE_SEED, device=dev)
            zero_counts()
            t0 = time.perf_counter()
            meshed = fm_eng.replay_fleet(batch, mesh=m, axis="data")
            meshed_s = time.perf_counter() - t0
            c_fleet = read_counts()
            digests = [digest_of(meshed["pose"][b]) for b in range(2)]
            say(f"meshed fleet B=2: digests {[d[:16] for d in digests]}, phase 17's "
                f"{[d[:16] for d in fleet_digests]}; {meshed_s:.3f} s (captures included); launches {c_fleet} {card}")
            check(digests == fleet_digests, "the meshed fleet differs from the unmeshed fleet (phase 17)")
            check(c_fleet["K1"] > 0 and c_fleet["K3"] > 0, "meshed fleet: K1 or K3 never launched")
            del fm_eng
        finally:
            torch.distributed.destroy_process_group()
    say(f"phase 20 wall time {time.perf_counter() - t_dist:.1f} s {card}")

    torch.cuda.synchronize()
    say(f"wall time {time.perf_counter() - t_start:.1f} s")

    # each kernel at the engine's shape (B=1) and at B=256 (the scan-match
    # pairs), K1 at the scan-to-map shape; launches: the kernel's count over
    # the replay (phase 16; K2's over the exact replay), K1 at the
    # scan-to-map shape over the garden course run
    batch = "scan-match pairs"
    kernels = [
        {"name": f"K1 fused_gather ({shape})", "route": "cuda",
         "source": "rivslam_tpu_torch/csrc/nn_gather.cu", "replaces": "rivslam_tpu/ops/pallas_nn.py:179",
         "launches": rp_counts["K1"], "max_abs_err": k1_err, **t}
        for shape, t in (("engine B=1", k1), ("B=256", timing[("K1", batch)]))
    ] + [
        {"name": f"K2 fused_correspondence ({shape})", "route": "cuda",
         "source": "rivslam_tpu_torch/csrc/nn_corr.cu", "replaces": "rivslam_tpu/ops/pallas_nn.py:74",
         "launches": x_counts["K2"], "max_abs_err": k2_err, **t}
        for shape, t in (("exact engine B=1", k2), ("B=256", timing[("K2", batch)]))
    ] + [
        {"name": f"K3 nearest_neighbor ({shape})", "route": "cuda",
         "source": "rivslam_tpu_torch/csrc/nn_argmin.cu", "replaces": "rivslam_tpu/ops/pallas_nn.py:29",
         "launches": rp_counts["K3"], "max_abs_err": k3_err, **t}
        for shape, t in (("engine B=1", k3), ("B=256", timing[("K3", batch)]))
    ] + [
        {"name": "K1 fused_gather (scan-to-map B=1, M=5120)", "route": "cuda",
         "source": "rivslam_tpu_torch/csrc/nn_gather.cu", "replaces": "rivslam_tpu/ops/pallas_nn.py:179",
         "launches": s2m_launches, "max_abs_err": k1_s2m_err, **k1_s2m_t},
        {"name": "window solve (engine W=6)", "route": "cuda", "source": "rivslam_tpu_torch/csrc/window_lm.cu",
         "replaces": None, "launches": eng_counts["window"], "max_abs_err": win_err, **window_t},
    ]
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
