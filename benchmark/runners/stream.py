"""The stream runner: radar frames through ``Engine.process_frame`` as a
closed loop, the way a live radar (4 Hz) or an offline replay at full speed
feeds the engine.

Set-up generates one recording of the configuration's course (its noise,
IMU and barometer drawn from the traffic's ``recording_seed``;
``traffic/synthetic.py``), builds the Engine with that seed's RANSAC key
chain, and runs the recording's first frames until the traffic's warm-up is
done (every CUDA graph captured and, where the mix asks,
the first loop closure and its global solve behind it). The window then feeds
the next frames one after another for ``seconds``: each frame is handed over
(its cloud uploaded, its IMU batch with it) only after the previous one has
returned. A frame's latency runs from its hand-over to ``process_frame``'s
return, which reads the frame's outputs back to the host. Every seed replays
the same recording, as a bag is replayed, and draws the sample the check
reads: runs over each seed's own noise differed in work (cp on an H100:
0-10 global solves in a 45 s window, 6.0-7.1 frames/s, where two runs of
one seed agreed within 3%).

The check (after the window, on the program's state freed) follows the
program step by step, since a float32 run and a float64 run part by
rounding within a frame and no whole-run comparison has a tight limit. For
a sample of the window's frames, drawn from the seed before the window, the
program's state before the frame is kept, and the frozen reference
(``benchmark/reference/plain``, float64) runs that frame's preprocessing
and window backend from it, with the same scan, IMU batch and RANSAC draws
and the program's own odometry pose: the ego velocity (preprocessing), the
window's pose and chi2 (backend) are compared. Each registration those
frames run (odometry, scan-to-map, loop verification) is kept with its
inputs and held by ``reference/gicp.py`` on its own prepared clouds: its
reported error against the error at its answer, and the Gauss-Newton step
from its answer against the configuration's stopping rule (odometry). A
sample of the window's global solves is held by ``reference/pose_graph.py``:
the objective at the program's answer over its minimum from the graph the
program's solve received (keyframe graph).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness
from benchmark.reference import convert, pose_graph
from benchmark.traffic import synthetic

# the Engine's stage scopes (record_function) that per-layer metrics read
SPANS = ("engine.preprocess", "engine.odometry", "engine.backend", "backend.window_solve",
         "backend.preintegrate", "backend.information", "engine.keyframe", "engine.loop_detection",
         "engine.global_solve", "odometry.scan_to_map", "bench.frame")


def course_for(config: dict, seed: int, n_frames: int) -> synthetic.Course:
    return synthetic.simulate_sequence(seed=seed, n_frames=n_frames, **config["course"])


def frame_inputs(course: synthetic.Course, i: int, capacity: int, imu_capacity: int) -> dict:
    f = course.frames[i]
    dts, acc, gyr, m = course.imu_for_frame(i, imu_capacity)
    return dict(frame=f, capacity=capacity, imu=(dts, acc, gyr, m), altitude=course.baro_at(f["stamp"]))


def hand_over(eng, system, inp: dict) -> dict:
    """One frame as a user hands it to the engine: the scan uploaded, then
    ``process_frame`` with the IMU batch since the previous frame."""
    f = inp["frame"]
    cloud = system.pointcloud.RadarCloud.from_numpy(
        f["xyz"], inp["capacity"], doppler=f["doppler"], intensity=f["intensity"],
        dtype=eng.dtype, device=eng.device,
    )
    return eng.process_frame(cloud, f["stamp"], *inp["imu"], altitude=inp["altitude"])


class SolveCapture:
    """Keeps the graph each global solve received and what it returned (the
    solved graph, its edge chi2), while ``on``: ``block_schur.
    solve_pose_graph_schur``, which the Engine calls through its module. The
    keyframe graph is never written in place (its rows are replaced by
    copies), so keeping them costs nothing. ``close`` puts the function back."""

    def __init__(self, block_schur):
        self.on = False
        self.solves: list = []
        self._module, self._inner = block_schur, block_schur.solve_pose_graph_schur
        inner = self._inner

        def solve(g, *args, **kwargs):
            g_out, chi2 = inner(g, *args, **kwargs)
            if self.on:
                self.solves.append({"graph": g, "solved": g_out, "chi2": chi2.clone()})
            return g_out, chi2

        block_schur.solve_pose_graph_schur = solve

    def close(self) -> None:
        self._module.solve_pose_graph_schur = self._inner


class RegistrationCapture:
    """Keeps a copy of each registration's inputs and answer
    (``apdgicp.register_dispatch``, which the odometry and loop verification
    call through their module) while ``frame`` names a sampled frame. Off, it
    costs one call. ``close`` puts the module's function back."""

    def __init__(self, apdgicp):
        self.frame = None
        self.calls: dict[int, list] = {}
        self._module, self._inner = apdgicp, apdgicp.register_dispatch
        inner = self._inner

        def register_dispatch(source, target, guess, cfg, *args, **kwargs):
            res = inner(source, target, guess, cfg, *args, **kwargs)
            if self.frame is not None and source.xyz.ndim == 3:  # the batched call does the work
                self.calls.setdefault(self.frame, []).append(convert.clone(
                    {"source": source, "target": target, "guess": torch.as_tensor(guess), "cfg": cfg,
                     "T": res.T, "error": res.error}))
            return res

        apdgicp.register_dispatch = register_dispatch

    def close(self) -> None:
        self._module.register_dispatch = self._inner


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, system, t_start: float,
        sizes: dict | None = None, control: bool = False) -> dict:
    """One run of a stream cell. ``system`` is the engine under test;
    ``sizes`` overrides traffic parameters for a rehearsal at small sizes;
    ``control`` also reads the control's numbers at the checked steps."""
    tr = {**cell.traffic, **(sizes or {})}
    n_frames = tr["warmup_max_frames"] + int(math.ceil(tr["max_frames_per_s"] * seconds)) + 1
    course = course_for(cell.config, tr["recording_seed"], n_frames)
    cfg = harness.engine_config(cell.config["engine"], system.config)
    regs, solves = RegistrationCapture(system.apdgicp), SolveCapture(system.block_schur)
    try:
        eng = system.pipeline.Engine(cfg, dtype=torch.float32, seed=tr["recording_seed"], device=device)
        out = _drive(eng, system, course, seed, seconds, trace, device, t_start, tr, regs, solves)
        del eng
    finally:
        regs.close()
        solves.close()
    if device.type == "cuda":  # the program's state goes before the reference runs
        torch.cuda.empty_cache()
    gaps, control_gaps = check(cell, course, seed, device, out.pop("check"), regs.calls, tr, control)
    out["gaps"] = gaps
    out["checks"] = harness.checks_of(gaps, cell.limits)
    out["checks"]["frames_checked"] = {"value": gaps["frames_checked"], "limit": cell.limits["min_frames_checked"],
                                       "at_least": True}
    if control:
        out["control_gaps"] = control_gaps
    return out


def _drive(eng, system, course, seed, seconds, trace, device, t_start, tr, regs, solves) -> dict:
    """Warm-up, then the window; returns the result's parts and what the
    check needs."""
    cap, imu_cap = tr["capacity"], tr["imu_capacity"]
    i, loops_in_warmup = 0, 0
    while i < tr["warmup_max_frames"]:
        out = hand_over(eng, system, frame_inputs(course, i, cap, imu_cap))
        loops_in_warmup += bool(out["loop_found"])
        i += 1
        if i >= tr["warmup_min_frames"] and (loops_in_warmup or not tr["warmup_until_loop"]):
            break
    first = i

    # the sample to check, drawn from the seed before the window
    pick = np.random.default_rng([seed, 1])
    samples = {first + int(j) for j in pick.choice(tr["check_span"], size=tr["check_frames"], replace=False)}
    snaps: dict[int, dict] = {}
    outputs: dict[int, dict] = {}
    latencies: list[float] = []
    prof = None
    traced = range(first + tr["trace_start"], first + tr["trace_start"] + tr["trace_frames"]) if trace else range(0)
    reg_graphs, graphs = eng.reg_graphs, eng.graphs
    count0 = {
        "reg": reg_graphs.replays if reg_graphs is not None else None,
        "solve": graphs.solve.replays if graphs is not None else None,
        "graph_opt": len(eng.timers.samples.get("graph_opt", [])),
    }

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    solves.on = True
    while time.perf_counter() - t_w0 < seconds and i < course.num_frames:
        inp = frame_inputs(course, i, cap, imu_cap)
        if i in samples:
            st = eng.state
            snaps[i] = convert.clone({"backend": st.backend, "floor_prev": st.floor_prev})
            regs.frame = i
        if trace and i == traced.start:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_tr0 = time.perf_counter()
        t0 = time.perf_counter()
        with record_function("bench.frame"):
            out = hand_over(eng, system, inp)
        latencies.append(time.perf_counter() - t0)
        regs.frame = None
        if trace and i == traced.stop - 1:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_tr1 = time.perf_counter()
            prof.__exit__(None, None, None)
        if i in samples:
            outputs[i] = {k: out[k] for k in ("ego_velocity", "odom", "pose", "chi2")}
        i += 1
    window_s = time.perf_counter() - t_w0
    solves.on = False
    frames = i - first
    if prof is not None and i < traced.stop:
        prof.__exit__(None, None, None)
        prof = None

    lat = np.asarray(latencies)
    metrics = {
        "frames_per_s": harness.metric(frames / window_s, "frames/s"),
        "frame_ms_p95": harness.metric(np.percentile(lat, 95) * 1e3, "ms"),
        "setup_s": harness.metric(setup_s, "s"),
    }
    dev_info = harness.device_info(device)
    q = np.percentile(lat, [50, 90, 95, 99]) * 1e3
    print(f"stream: {frames} frames in {window_s:.3f} s after {first} warm-up frames "
          f"({loops_in_warmup} loop closures in the warm-up); frame ms p50 {q[0]:.3f}, p90 {q[1]:.3f}, "
          f"p95 {q[2]:.3f}, p99 {q[3]:.3f}, max {lat.max() * 1e3:.3f}; {int((lat > 0.25).sum())} frames over "
          f"250 ms; {len(solves.solves)} global solves in the window", flush=True)

    run_info = {
        "frames": frames, "latencies_s": lat, "trace": None, "traced_frames": 0, "replays": {},
        "graph_opt_s": eng.timers.samples.get("graph_opt", [])[count0["graph_opt"]:],
    }
    if count0["reg"] is not None:
        run_info["replays"] = {"registration": reg_graphs.replays - count0["reg"],
                               "window_solve": graphs.solve.replays - count0["solve"]}
    if prof is not None:
        tr_obj = harness.read_trace(prof, t_tr1 - t_tr0, SPANS)
        run_info["trace"] = tr_obj
        run_info["traced_frames"] = len(traced)
        traced_ms = np.mean(tr_obj.spans.get("bench.frame", [float("nan")])) * 1e3
        untraced = np.delete(lat, [k - first for k in traced])
        print(f"tracing overhead: traced frame ms mean {traced_ms:.3f} against untraced median "
              f"{np.median(untraced) * 1e3:.3f}", flush=True)
        dev_info["busy_s"] = tr_obj.busy_s()
        dev_info["window_s"] = tr_obj.wall_s
    return {"frames": frames, "metrics": metrics, "device": dev_info, "run": run_info,
            "check": {"snaps": snaps, "outputs": outputs, "solves": solves.solves}}


def frame_draws(ref, seed: int, i: int, shapes, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame i's RANSAC scores as the engine draws them: subkey i+1 of the
    seed's key chain, one float32 draw of the larger shape, REVE taking its
    leading rows and the floor its own; cast to ``dtype``."""
    key = ref.prng.key(seed)
    for _ in range(i + 1):
        key, sub = ref.prng.split(key)
    (r_reve, n), (r_floor, _) = shapes
    u = ref.prng.uniform_stack([sub], (max(r_reve, r_floor), n), torch.float32, device)[0].to(dtype)
    return u[:r_reve], u[:r_floor]


def _frame_tensors(course, i: int, tr: dict, ref, dtype, device):
    inp = frame_inputs(course, i, tr["capacity"], tr["imu_capacity"])
    f = inp["frame"]
    cloud = ref.pointcloud.RadarCloud.from_numpy(
        f["xyz"], tr["capacity"], doppler=f["doppler"], intensity=f["intensity"], dtype=dtype, device=device)
    dts, acc, gyr, m = inp["imu"]
    ang = gyr[np.argmax(m)] if m.any() else np.zeros(3)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(device)

    return cloud, (t(ang), t(f["stamp"]), t(dts), t(acc), t(gyr), t(m, torch.bool))


def reference_frame(ref, cfg, snap: dict, course, i: int, seed: int, tr: dict, odom, dtype, device) -> dict:
    """Frame i's preprocessing and window backend in the plain reference
    from the program's state before it (``snap``: the window backend and
    the floor chain), with the same scan, IMU batch and RANSAC draws, fed
    the program's own odometry pose ``odom`` for the frame (the registration
    is checked on its own, so the backend's answer carries none of its
    stopping slack). Returns the frame's ego velocity, the window's pose
    and its chi2."""
    s = convert.to_reference(snap, dtype, device)
    cloud, (ang, stamp, dts, acc, gyr, m) = _frame_tensors(course, i, tr, ref, dtype, device)
    draws = frame_draws(ref, seed, i, ref.frame.draw_shapes(cfg, tr["capacity"]), dtype, device)
    cl, ego, fl, _ = ref.frame.preprocess(cfg, cloud, ang, s["floor_prev"], draws)
    pose = torch.as_tensor(np.asarray(odom), dtype=dtype, device=device)
    frame = ref.slam.BackendFrame(
        stamp=stamp, odom_R=pose[:3, :3], odom_p=pose[:3, 3], xyz=cl.xyz, mask=cl.mask, ego_vel=ego.v,
        ego_vel_cov=ego.sigma**2, imu_dts=dts, imu_acc=acc, imu_gyr=gyr, imu_mask=m, floor=fl.coeffs,
        floor_valid=fl.found)
    _, bout = ref.slam.backend_step(s["backend"], frame, cfg.backend, cfg.imu)
    return {"ego_velocity": ego.v.cpu().numpy(), "pose": bout.pose.cpu().numpy(), "chi2": float(bout.chi2)}


def registration_numbers(call: dict, device, ref=None) -> tuple[np.ndarray, np.ndarray]:
    """Each problem of a kept registration, by ``reference.gicp`` in float64
    on the registration's own prepared clouds: (the gap between its
    reported error and the error at its answer, relative, outside the range
    that points on the correspondence limit allow; the Gauss-Newton step
    from its answer in units of the configuration's stopping rule). With
    ``ref``, the answer and its error are the control's: the frozen
    reference registering the same inputs in float32 with TF32 on."""
    f64 = torch.float64
    cfg = call["cfg"]
    src64, tgt64 = (convert.to_reference(call[k], f64, device) for k in ("source", "target"))
    T, err = call["T"], call["error"]
    if ref is not None:
        with harness.tf32():
            src, tgt = (convert.to_reference(call[k], torch.float32, device) for k in ("source", "target"))
            res = ref.apdgicp.register_dispatch(src, tgt, call["guess"].to(device, torch.float32),
                                                convert.to_reference(cfg, f64, device), device=device)
            T, err = res.T, res.error
    T = T.to(device, f64)
    lo, hi = harness.registration_error(cfg, src64, tgt64, T, band=harness.BAND)
    step = harness.registration_problem(cfg, src64, tgt64).step_units(T)
    return harness.band_gap(err, lo, hi), step.cpu().numpy()


def _trans_gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b)[:3, 3]))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def check(cell, course, seed, device, kept: dict, reg_calls: dict, tr: dict, control: bool = False):
    """The program's sampled frames, registrations and global solves
    against the reference in float64, each from the program's state before
    it. Returns (gaps, the control's gaps, or None without ``control``);
    the cell's limits name the gaps it compares. ``gaps["items"]`` holds
    the numbers of each checked frame, registration and solve."""
    harness.set_tf32(False)
    ref = harness.reference_system()
    cfg = harness.engine_config(cell.config["engine"], ref.config)
    f64, f32 = torch.float64, torch.float32
    key = tr["recording_seed"]  # the Engine's key chain; ``seed`` draws the sample
    sides = ("program", "control") if control else ("program",)
    g = {s: {} for s in sides}
    items: dict = {"frames": {}, "registrations": [], "solves": []}

    def put(side, name, value):
        g[side][name] = max(g[side].get(name, 0.0), float(value))

    outputs, snaps = kept["outputs"], kept["snaps"]
    for i in sorted(outputs):
        got = outputs[i]
        want = reference_frame(ref, cfg, snaps[i], course, i, key, tr, got["odom"], f64, device)
        frame = {"ego_vel_gap_mps": float(np.abs(got["ego_velocity"] - want["ego_velocity"]).max()),
                 "backend_pose_gap_m": _trans_gap(got["pose"], want["pose"]),
                 "backend_chi2_gap": _rel(got["chi2"], want["chi2"])}
        items["frames"][i] = frame
        for name, value in frame.items():
            put("program", name, value)
        if control:
            with harness.tf32():
                c = reference_frame(ref, cfg, snaps[i], course, i, key, tr, got["odom"], f32, device)
            put("control", "ego_vel_gap_mps", np.abs(c["ego_velocity"] - want["ego_velocity"]).max())
            put("control", "backend_pose_gap_m", _trans_gap(c["pose"], want["pose"]))
            put("control", "backend_chi2_gap", _rel(c["chi2"], want["chi2"]))
    calls = [(i, c) for i in sorted(reg_calls) for c in reg_calls[i]]
    for side in sides:
        per = {"reg": [], "submap_reg": []}
        steps = []
        for i, c in calls:
            # scan against scan (odometry, loop verification), or against a
            # merged submap (scan-to-map), whose near-duplicate points put
            # near-ties in the nearest-neighbour choice
            kind = "submap_reg" if c["target"].xyz.shape[-2] > c["source"].xyz.shape[-2] else "reg"
            err, step = registration_numbers(c, device, ref if side == "control" else None)
            per[kind].append(err)
            steps.append(step)
            if side == "program":
                items["registrations"].append({"frame": i, "kind": kind, "batch": len(step),
                                               "error_gap": err.tolist(), "step": step.tolist()})
        for kind, gaps_ in per.items():
            if gaps_:
                gaps_ = np.concatenate(gaps_)
                put(side, f"{kind}_error_gap_p50", np.median(gaps_))
                put(side, f"{kind}_error_gap_max", gaps_.max())
        if steps:
            steps = np.concatenate(steps)
            put(side, "reg_step_p50", np.median(steps))
            put(side, "reg_step_p90", np.percentile(steps, 90))
    solves = kept["solves"]
    chosen = []
    if solves and tr["check_solves"]:
        pick = np.random.default_rng([seed, 2])
        chosen = sorted(pick.choice(len(solves), size=min(tr["check_solves"], len(solves)), replace=False))
    for s in chosen:
        sv = solves[s]
        graph = pose_graph.Graph(sv["graph"])  # the Engine's solve keeps the Huber width at 1
        excess = graph.excess(sv["solved"].R, sv["solved"].p)
        _, best_p, _ = graph.minimize(sv["solved"].R[:graph.n], sv["solved"].p[:graph.n])
        gap = float((sv["solved"].p[:graph.n].to(f64) - best_p).norm(dim=-1).max())
        items["solves"].append({"index": int(s), "nodes": graph.n, "solve_excess": excess, "global_solve_gap_m": gap})
        put("program", "solve_excess", excess)
        put("program", "global_solve_gap_m", gap)
    gaps = {**g["program"], "frames_checked": len(outputs), "registrations_checked": len(calls),
            "solves_checked": len(chosen)}
    ctrl = g["control"] if control else None
    print(f"stream check: {gaps}" + (f"; control {ctrl}" if control else ""), flush=True)
    gaps["items"] = items
    return gaps, ctrl
