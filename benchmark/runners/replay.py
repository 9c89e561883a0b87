"""The replay runner: stretches of a recording through
``Engine.replay_sequence``, the reference's whole-sequence replay, as a team
re-running odometry offline over recorded bags at full speed calls it.

Set-up generates one recording of the configuration's course (noise, IMU,
barometer and the Engine's RANSAC key from the traffic's
``recording_seed``), cuts it into ``stretches`` distinct stretches of
``stretch`` consecutive frames, stacked as ``io.datasets.stack_sequence``
stacks a sequence (host arrays; each frame's IMU batch the samples since
the previous frame of the recording), builds the Engine and replays stretch
0 once (every CUDA graph captured). The window then replays stretches in an
order drawn from the run's seed; a stretch starts only while the window is
open, and each call runs from the upload to the outputs on the host. The
window ends when the last stretch finishes, so no stretch is cut:
``frames_per_s`` is every finished stretch's frames over the time from the
window's start to that finish. The keyframe graph is not replayed (loop
closure off, as ``replay_sequence`` is). The program's tracer
(``eval/timing.StageTimers``) is on over the window: ``host_syncs`` under
``engine.replay``. A ``--trace 1`` run also replays the first
``trace_frames`` frames of stretch 0 once more after the window, under
``torch.profiler``, for the device's idle share.

The check (after the window, in float64): one of the window's first
``check_span_calls`` stretches, drawn from the seed before the window. The
replay starts each stretch from a fresh state, so the frozen reference
(``benchmark/reference/plain``) runs the stretch's preprocessing frame by
frame from that state (the floor chain), with the same scans, IMU batches
and RANSAC draws (the Engine's key chain at the stretch's frames): each
checked frame's ego velocity against the replay's (``ego_vel_gap_mps``);
the window backend over the stretch's first ``backend_frames`` frames, from
the program's fresh backend state and fed the replay's odometry, against
the replay's pose and chi2 (``backend_pose_gap_m``, ``backend_chi2_gap``);
the odometry answer of each sampled converged frame (its pose relative to
its keyframe), kept with the registration's inputs as the replay produced
them (``stream.RegistrationCapture``), held by ``reference/gicp.py`` on its
own prepared clouds: the Gauss-Newton step from it in units of the
stopping rule (``reg_step_p50``) and, read but not compared, its reported
error against the error at it (``reg_error_gap_p50``).
On the reference's own float64 covariances of the frozen preprocessing the
step of a converged answer reads 0.8-7 units: where a point's two smallest
eigenvalues nearly tie, float32 and float64 regularize it about different
plane normals.
The control (``control``) runs the frozen preprocessing and backend in
float32 with TF32 on in the program's place.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness
from benchmark.reference import convert
from benchmark.runners import stream
from benchmark.traffic import synthetic

SPANS = ("bench.replay", "engine.replay", "replay.draws", "replay.upload", "replay.frame", "replay.read",
         "engine.preprocess", "engine.odometry", "engine.backend")


def make_stretches(config: dict, tr: dict) -> tuple[synthetic.Course, list[dict]]:
    """The recording and its stretches, as stacked host arrays."""
    F, ns, cap, imu_cap = tr["stretch"], tr["stretches"], tr["capacity"], tr["imu_capacity"]
    course = synthetic.simulate_sequence(seed=tr["recording_seed"], n_frames=ns * F, **config["course"])
    out = []
    for s in range(ns):
        frames = range(s * F, s * F + F)
        xyz, dop, inten, mask = (np.stack(a) for a in zip(*(course.padded(i, cap) for i in frames)))
        dts, acc, gyr, imask = (np.stack(a) for a in zip(*(course.imu_for_frame(i, imu_cap) for i in frames)))
        out.append(dict(xyz=xyz.astype(np.float32), doppler=dop.astype(np.float32),
                        intensity=inten.astype(np.float32), mask=mask,
                        stamps=np.asarray([course.frames[i]["stamp"] for i in frames], np.float64),
                        imu_dts=dts, imu_acc=acc, imu_gyr=gyr, imu_mask=imask))
    return course, out


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, system, t_start: float,
        sizes: dict | None = None, control: bool = False) -> dict:
    """One run of a replay cell (see ``stream.run`` for the arguments)."""
    timing = importlib.import_module("rivslam_tpu_torch.eval.timing")
    slam = importlib.import_module("rivslam_tpu_torch.backend.slam")
    tr = {**cell.traffic, **(sizes or {})}
    F = tr["stretch"]
    course, stretches = make_stretches(cell.config, tr)
    cfg = harness.engine_config(cell.config["engine"], system.config)
    on_card = device.type == "cuda"
    tracer = timing.StageTimers()
    eng = system.pipeline.Engine(cfg, dtype=torch.float32, seed=tr["recording_seed"], device=device, timers=tracer)
    fresh = convert.clone(slam.init_state(cfg.backend, cfg.imu, tr["capacity"], torch.float32, device))
    eng.replay_sequence(stretches[0])  # warm-up: every graph captured
    drawn = F  # frames of the Engine's key chain drawn so far

    order = np.random.default_rng([seed, 4]).permutation(len(stretches))
    checked_call = int(np.random.default_rng([seed, 1]).integers(tr["check_span_calls"]))
    kept = None
    calls: list = []
    prof = None
    regs = stream.RegistrationCapture(system.apdgicp)
    try:
        if on_card:
            torch.cuda.synchronize(device)
        tracer.on()
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        k = 0
        while time.perf_counter() - t_w0 < seconds:
            s = int(order[k % len(stretches)])
            regs.frame = 0 if k == checked_call else None  # one registration a frame after the first
            t0 = time.perf_counter()
            with record_function("bench.replay"):
                out = eng.replay_sequence(stretches[s])
            calls.append(time.perf_counter() - t0)
            regs.frame = None
            if k == checked_call:
                kept = {"stretch": s, "offset": drawn, "outputs": out, "registrations": regs.calls.pop(0, [])}
            drawn += F
            k += 1
        window_s = time.perf_counter() - t_w0
    finally:
        tracer.off()
        regs.close()
    totals = tracer.totals()
    replay_spans = sum(1 for r in tracer.records() if r[0] == "engine.replay")
    frames = k * F

    metrics = {
        "frames_per_s": harness.metric(frames / window_s, "frames/s"),
        "setup_s": harness.metric(setup_s, "s"),
    }
    syncs = totals["host_syncs"]
    run_info = {"frames": frames, "stretches": k, "trace": None, "call_s": calls,
                "engine_replay_spans": replay_spans,
                # in the window only replay calls run: every sync inside a span is under engine.replay
                "host_syncs_replay": sum(v for key, v in syncs.items() if key != timing.OUTSIDE),
                "host_syncs_by_span": syncs}
    print(f"replay: {k} stretches of {F} frames in {window_s:.3f} s after one of warm-up; stretch s "
          f"{min(calls):.3f}-{max(calls):.3f}; host syncs a frame {run_info['host_syncs_replay'] / max(frames, 1):.2f} "
          f"(outside any span {syncs.get(timing.OUTSIDE, 0)})", flush=True)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        part = {key: v[:tr["trace_frames"]] for key, v in stretches[0].items()}
        if on_card:
            torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_tr0 = time.perf_counter()
            with record_function("bench.replay"):
                eng.replay_sequence(part)
            if on_card:
                torch.cuda.synchronize(device)
            t_tr1 = time.perf_counter()
        tr_obj = harness.read_trace(prof, t_tr1 - t_tr0, SPANS)
        run_info["trace"] = tr_obj
        run_info["traced_frames"] = tr["trace_frames"]
    dev_info = harness.device_info(device)
    if prof is not None:
        dev_info["busy_s"] = run_info["trace"].busy_s()
        dev_info["window_s"] = run_info["trace"].wall_s
    del eng
    if on_card:
        torch.cuda.empty_cache()
    gaps, control_gaps = check(cell, course, fresh, kept, device, tr, control)
    checks = harness.checks_of(gaps, cell.limits)
    checks["frames_checked"] = {"value": gaps["frames_checked"], "limit": cell.limits["min_frames_checked"],
                                "at_least": True}
    out = {"frames": frames, "metrics": metrics, "device": dev_info, "run": run_info, "gaps": gaps,
           "checks": checks}
    if control:
        out["control_gaps"] = control_gaps
    return out


def _chain(ref, cfg, course, tr, kept, fresh, upto: int, dtype, device) -> list[dict]:
    """The frozen reference over the kept stretch's frames 0..upto-1 in
    ``dtype``: the preprocessing from the fresh floor, and the window
    backend over the first ``backend_frames`` from the program's fresh
    state, fed the replay's odometry. Per frame: the ego velocity, and the
    backend's pose and chi2 where it ran."""
    out = kept["outputs"]
    i0 = kept["stretch"] * tr["stretch"]
    floor_prev = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dtype, device=device)
    state = convert.to_reference(fresh, dtype, device)
    rows = []
    for j in range(upto):
        cloud, (ang, stamp, dts, acc, gyr, m) = stream._frame_tensors(course, i0 + j, tr, ref, dtype, device)
        draws = stream.frame_draws(ref, tr["recording_seed"], kept["offset"] + j,
                                   ref.frame.draw_shapes(cfg, tr["capacity"]), dtype, device)
        cl, ego, fl, floor_prev = ref.frame.preprocess(cfg, cloud, ang, floor_prev, draws)
        row = {"ego_velocity": ego.v.cpu().numpy()}
        if j < tr["backend_frames"]:
            pose = torch.as_tensor(out["odom"][j], dtype=dtype, device=device)
            frame = ref.slam.BackendFrame(
                stamp=stamp, odom_R=pose[:3, :3], odom_p=pose[:3, 3], xyz=cl.xyz, mask=cl.mask, ego_vel=ego.v,
                ego_vel_cov=ego.sigma**2, imu_dts=dts, imu_acc=acc, imu_gyr=gyr, imu_mask=m, floor=fl.coeffs,
                floor_valid=fl.found)
            state, bout = ref.slam.backend_step(state, frame, cfg.backend, cfg.imu)
            row["pose"], row["chi2"] = bout.pose.cpu().numpy(), float(bout.chi2)
        rows.append(row)
    return rows


def check(cell, course, fresh, kept, device, tr: dict, control: bool = False):
    """The kept stretch against the frozen reference in float64 (see the
    module's docstring). Returns (gaps, the control's gaps, or None without
    ``control``); ``gaps["items"]`` holds each checked frame's numbers."""
    harness.set_tf32(False)
    if kept is None:
        return {"frames_checked": 0}, ({} if control else None)
    ref = harness.reference_system()
    cfg = harness.engine_config(cell.config["engine"], ref.config)
    reg_cfg = cfg.registration
    f64, f32 = torch.float64, torch.float32
    out = kept["outputs"]
    pick = np.random.default_rng([kept["stretch"], kept["offset"], 5])
    sampled = sorted(int(j) for j in 1 + pick.choice(tr["check_span"] - 1, size=tr["check_frames"], replace=False))
    upto = max(sampled[-1] + 1, tr["backend_frames"])
    want = _chain(ref, cfg, course, tr, kept, fresh, upto, f64, device)
    sides = {"program": None}
    if control:
        with harness.tf32():
            sides["control"] = _chain(ref, cfg, course, tr, kept, fresh, upto, f32, device)
    g = {s: {} for s in sides}

    def put(side, name, value):
        g[side][name] = max(g[side].get(name, 0.0), float(value))

    items: dict = {"frames": {}, "registrations": []}
    ego_frames = sorted(set(sampled) | set(range(tr["backend_frames"])))
    for j in ego_frames:
        frame = {"ego_vel_gap_mps": float(np.abs(out["ego_vel"][j] - want[j]["ego_velocity"]).max())}
        if j < tr["backend_frames"]:
            frame["backend_pose_gap_m"] = float(np.linalg.norm(out["pose"][j][:3, 3] - want[j]["pose"][:3, 3]))
            frame["backend_chi2_gap"] = abs(float(out["chi2"][j]) - want[j]["chi2"]) / max(abs(want[j]["chi2"]), 1e-30)
        items["frames"][j] = frame
        for name, value in frame.items():
            put("program", name, value)
        if control:
            c = sides["control"][j]
            put("control", "ego_vel_gap_mps", np.abs(c["ego_velocity"] - want[j]["ego_velocity"]).max())
            if j < tr["backend_frames"]:
                put("control", "backend_pose_gap_m", np.linalg.norm(c["pose"][:3, 3] - want[j]["pose"][:3, 3]))
                put("control", "backend_chi2_gap", abs(c["chi2"] - want[j]["chi2"]) / max(abs(want[j]["chi2"]), 1e-30))
    steps, errs = [], []
    for i in sampled:
        if not bool(out["converged"][i]):
            continue
        err, step = stream.registration_numbers(kept["registrations"][i - 1], device)  # frame 0 registers nothing
        steps.append(float(step[0]))
        errs.append(float(err[0]))
        items["registrations"].append({"frame": i, "step": steps[-1], "error_gap": errs[-1]})
    if steps:
        put("program", "reg_step_p50", np.median(steps))
        put("program", "reg_step_p90", np.percentile(steps, 90))
        put("program", "reg_error_gap_p50", np.median(errs))
    gaps = {**g["program"], "frames_checked": len(ego_frames), "registrations_checked": len(steps),
            "stretch": kept["stretch"], "key_offset": kept["offset"]}
    ctrl = g["control"] if control else None
    print(f"replay check: {gaps}" + (f"; control {ctrl}" if control else ""), flush=True)
    gaps["items"] = items
    return gaps, ctrl
