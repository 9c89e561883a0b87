"""The voxel-match runner: batches of frame pairs through the public,
eager scan-match entry (``apdgicp.prepare`` of the sources and of the
targets, then ``register_dispatch``) under a voxel registration
(FAST_VGICP), as a server aligning many radar scan pairs with fast_gicp's
VGICP calls it (map merging, batched loop verification).

The batches, their order and the timing are the scan-match runner's
(``make_batches``, ``register_batch``): ``batches`` distinct batches of
``batch`` consecutive pairs of one recording, identity guess, cycled in an
order drawn from the run's seed, a batch ending when its poses are read
back. So the cells of the two runners differ in the method, and in one
thing more: here the window runs whole cycles of the batches (a cycle
starts only while the window is open, and ``pairs_per_s`` is every
finished cycle's pairs over the time to the last one's finish), since a
VGICP batch whose slowest pair runs the LM to its cap costs ~10x another
and a part cycle at the window's end moved the rate by up to ~8%. The
program's tracer (``eval/timing.StageTimers``) is on over the window: the
voxel maps' builds (span ``registration.voxel_map``), the LM's outer
iterations (``lm_iterations``; on the card ``register_dispatch`` replays a
voxel registration's iterations as CUDA graphs) and the maps built
(``voxel_maps``).

The check (after the window, on the program's state freed): a sample of
the window's batches, drawn from the seed before the window, against
``reference/vgicp.py`` and ``reference/gicp.py`` in float64, in blocks of
pairs: the prepares' covariances against the reference's covariances of
the same scans (``cov_gap_p50``); the voxel map the registration built,
kept as it was built, against the reference's additive map of the same
prepared target (``voxel_cov_gap_p50``); each pair's reported error
against the reference's error at the pair's answer
(``reg_error_gap_p75``); the reference's Gauss-Newton step from that
answer in units of the stopping rule (``reg_step_p50``). The control
(``control``) is the reference in float32 with TF32 on in the program's
place: the frozen prepare, the voxel map of the same targets, and a
Gauss-Newton registration from the identity.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness
from benchmark.reference import convert
from benchmark.reference import vgicp as plain
from benchmark.runners.scan_match import (
    _blocks, cov_gaps, make_batches, reference_covariances, reference_prepare, register_batch)

SPANS = ("bench.batch", "apdgicp.prepare", "registration.voxel_map")


class MapCapture:
    """Keeps a copy of the voxel maps that ``vgicp.build_voxel_map`` builds
    while ``on`` (the registration calls it through its module), as they
    were built; ``close`` puts the function back."""

    def __init__(self, vgicp):
        self.on = False
        self.maps: list = []
        self._module, self._inner = vgicp, vgicp.build_voxel_map
        inner = self._inner

        def build_voxel_map(*args, **kwargs):
            vm = inner(*args, **kwargs)
            if self.on:
                self.maps.append(convert.clone({f: getattr(vm, f) for f in ("coords", "mean", "cov", "count")}))
            return vm

        vgicp.build_voxel_map = build_voxel_map

    def close(self) -> None:
        self._module.build_voxel_map = self._inner


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, system, t_start: float,
        sizes: dict | None = None, control: bool = False) -> dict:
    """One run of a voxel-match cell (see ``stream.run`` for the arguments)."""
    timing = importlib.import_module("rivslam_tpu_torch.eval.timing")
    vgicp = importlib.import_module("rivslam_tpu_torch.frontend.vgicp")
    tr = {**cell.traffic, **(sizes or {})}
    host = make_batches(cell.config, tr)
    order = np.random.default_rng([seed, 4]).permutation(len(host))
    reg_cfg = harness.engine_config(cell.config["engine"], system.config).registration
    batches = [{k: torch.as_tensor(v).to(device) for k, v in b.items()} for b in host]
    B = tr["batch"]
    guess = torch.eye(4, dtype=torch.float32, device=device).expand(B, 4, 4).contiguous()
    on_card = device.type == "cuda"
    for b in batches:  # warm-up: every batch once
        register_batch(system, reg_cfg, b, guess, device)

    pick = np.random.default_rng([seed, 3])  # the sample to check, drawn before the window
    samples = {int(k) for k in pick.choice(tr["check_span"], size=tr["check_batches"], replace=False)}
    kept: dict[int, dict] = {}
    traced = range(tr["trace_start"], tr["trace_start"] + tr["trace_batches"]) if trace else range(0)
    prof = None
    timings: list = []
    maps = MapCapture(vgicp)
    tracer = timing.StageTimers()
    try:
        if on_card:
            torch.cuda.synchronize(device)
        tracer.on()
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        k = 0
        # whole cycles: a cycle starts only while the window is open, so each
        # run weighs every batch alike (the batches' costs differ up to ~10x:
        # a batch whose slowest pair runs the LM to its cap of 64 iterations)
        while k % len(batches) or time.perf_counter() - t_w0 < seconds:
            b = int(order[k % len(batches)])
            if trace and k == traced.start:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                t_tr0 = time.perf_counter()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if on_card else None
            maps.on = k in samples
            with record_function("bench.batch"):
                src, tgt, res, T = register_batch(system, reg_cfg, batches[b], guess, device, events)
            maps.on = False
            if k in samples:
                kept[k] = {"batch": b, "T": T, "map": maps.maps.pop() if maps.maps else None,
                           **convert.clone({"source": src, "target": tgt, "error": res.error})}
            timings.append(events)
            if trace and k == traced.stop - 1:
                if on_card:
                    torch.cuda.synchronize(device)
                t_tr1 = time.perf_counter()
                prof.__exit__(None, None, None)
            k += 1
        window_s = time.perf_counter() - t_w0
    finally:
        tracer.off()
        maps.close()
    if prof is not None and k < traced.stop:
        prof.__exit__(None, None, None)
        prof = None

    metrics = {
        "pairs_per_s": harness.metric(k * B / window_s, "pairs/s"),
        "setup_s": harness.metric(setup_s, "s"),
    }
    dev_info = harness.device_info(device)
    totals = tracer.totals()
    run_info: dict = {"batches": k, "trace": None, "traced_batches": 0,
                      "lm_iterations": sum(totals["lm_iterations"].values()),
                      "voxel_maps": sum(totals.get("voxel_maps", {}).values())}
    if on_card:
        run_info["prepare_ms"] = [e[0].elapsed_time(e[1]) for e in timings]
        run_info["register_ms"] = [e[1].elapsed_time(e[2]) for e in timings]
    print(f"voxel_match: {k} batches of {B} pairs in {window_s:.3f} s; LM iterations {run_info['lm_iterations']} "
          f"({run_info['lm_iterations'] / max(k, 1):.2f} a batch); voxel maps {run_info['voxel_maps']}; host syncs "
          f"{sum(totals['host_syncs'].values())}" + (
              f"; device-event ms a batch: prepare {np.mean(run_info['prepare_ms']):.3f}, register "
              f"{np.mean(run_info['register_ms']):.3f}" if on_card else ""), flush=True)
    if prof is not None:
        tr_obj = harness.read_trace(prof, t_tr1 - t_tr0, SPANS)
        run_info["trace"] = tr_obj
        run_info["traced_batches"] = len(traced)
        run_info["scope_device_s"] = scope_device_seconds(prof, SPANS)
        dev_info["busy_s"] = tr_obj.busy_s()
        dev_info["window_s"] = tr_obj.wall_s

    del batches, src, tgt, res
    if on_card:
        torch.cuda.empty_cache()
    gaps, control_gaps = check(cell, host, kept, device, tr, control)
    checks = harness.checks_of(gaps, cell.limits)
    checks["pairs_checked"] = {"value": gaps["pairs_checked"], "limit": cell.limits["min_pairs_checked"],
                               "at_least": True}
    out = {"frames": k * B, "metrics": metrics, "device": dev_info, "run": run_info, "gaps": gaps,
           "checks": checks}
    if control:
        out["control_gaps"] = control_gaps
    return out


def scope_device_seconds(prof, names) -> dict:
    """The device seconds of the kernels launched inside each occurrence of
    the scopes ``names`` (``record_function``) of a finished profile, summed
    by name: the profiler's own attribution of a kernel to the scope its
    launch ran in. A name the trace lacks, or whose kernels it could not
    attribute, reads 0."""
    names = set(names)
    out = {n: 0.0 for n in names}
    for e in prof.events():
        if e.name in names and e.device_type == torch.autograd.DeviceType.CPU:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            out[e.name] += float(us) / 1e6
    return out


def check(cell, host: list[dict], kept: dict, device, tr: dict, control: bool = False):
    """The sampled batches against the references in float64 on the same
    pairs. Returns (gaps, the control's gaps, or None without ``control``);
    ``gaps["items"]`` holds each checked batch's numbers."""
    harness.set_tf32(False)
    ref = harness.reference_system()
    reg_cfg = harness.engine_config(cell.config["engine"], ref.config).registration
    f64, f32, block = torch.float64, torch.float32, tr["check_block"]
    res_m = reg_cfg.voxel_resolution
    sides = ("program", "control") if control else ("program",)
    cov, vox, err, step = ({s: [] for s in sides} for _ in range(4))
    for k in sorted(kept):
        c = kept[k]
        batch = host[c["batch"]]
        masks = (batch["src_mask"], batch["tgt_mask"])
        want_cov = [reference_covariances(reg_cfg, batch[f"{side}_xyz"], batch[f"{side}_mask"], block, device)
                    for side in ("src", "tgt")]
        for side, got_cov in enumerate((c["source"].cov, c["target"].cov)):
            cov["program"].append(cov_gaps(got_cov.double().cpu().numpy(), want_cov[side], masks[side]))
        if control:
            # the frozen prepare takes the GICP family's configurations; a
            # prepare does not depend on the method
            prep_cfg = dataclasses.replace(reg_cfg, method="FAST_GICP")
            with harness.tf32():
                ctrl_prep = reference_prepare(ref, prep_cfg, batch, block, f32, device)
            for side, got in enumerate(ctrl_prep):
                got_cov = np.concatenate([p.cov.double().cpu().numpy() for p in got])
                cov["control"].append(cov_gaps(got_cov, want_cov[side], masks[side]))
        vm = c["map"]
        for s, (src, tgt) in zip(plain.blocks(len(c["T"]), block),
                                 zip(_blocks(c["source"], block), _blocks(c["target"], block))):
            src64, tgt64 = (convert.to_reference(x, f64, device) for x in (src, tgt))
            problem = plain.Problem(src64.xyz, src64.mask, src64.cov, tgt64.xyz, tgt64.mask, tgt64.cov, reg_cfg)
            if vm is not None:
                vox["program"].append(plain.map_gaps(*(vm[f][s].to(device) for f in ("coords", "mean", "cov", "count")),
                                                     problem.map, res_m).cpu().numpy())
            answers = {"program": (torch.as_tensor(c["T"][s]).to(device, f64), c["error"][s])}
            if control:
                with harness.tf32():
                    ctrl = plain.Problem(src.xyz, src.mask, src.cov, tgt.xyz, tgt.mask, tgt.cov, reg_cfg, dtype=f32)
                    eye = torch.eye(4, dtype=f32, device=device).expand(len(c["T"][s]), 4, 4)
                    T_c, err_c = ctrl.register(eye)
                answers["control"] = (T_c.to(f64), err_c)
                vox["control"].append(plain.map_gaps(
                    *_program_rows(ctrl.map, len(c["T"][s])), problem.map, res_m).cpu().numpy())
            for side, (T, reported) in answers.items():
                want = problem.error(T)
                got = torch.as_tensor(reported).to(device, f64)
                err[side].append((torch.abs(got - want) / torch.abs(want).clamp_min(1e-30)).cpu().numpy())
                step[side].append(problem.step_units(T).cpu().numpy())

    def stats(side: str) -> dict:
        cv, vx, er, st = (np.concatenate(x[side] or [[np.nan]]) for x in (cov, vox, err, step))
        return {"cov_gap_p50": float(np.median(cv)), "cov_gap_p90": float(np.percentile(cv, 90)),
                "voxel_cov_gap_p50": float(np.median(vx)), "voxel_cov_gap_p90": float(np.percentile(vx, 90)),
                "voxel_cov_gap_max": float(vx.max()),
                "reg_error_gap_p50": float(np.median(er)), "reg_error_gap_p75": float(np.percentile(er, 75)),
                "reg_error_gap_max": float(er.max()), "reg_step_p50": float(np.median(st)),
                "reg_step_p90": float(np.percentile(st, 90)), "reg_step_max": float(st.max())}

    gaps = {**stats("program"), "pairs_checked": int(sum(len(e) for e in err["program"])),
            "voxels_checked": int(sum(len(v) for v in vox["program"]))}
    ctrl = stats("control") if control else None
    print(f"voxel_match check: {gaps}" + (f"; control {ctrl}" if control else ""), flush=True)
    gaps["items"] = {"batches": [int(kept[k]["batch"]) for k in sorted(kept)], "slots": sorted(int(k) for k in kept),
                     "error_gap": np.concatenate(err["program"] or [[]]).tolist(),
                     "step": np.concatenate(step["program"] or [[]]).tolist()}
    return gaps, ctrl


def _program_rows(vm: plain.VoxelMap, B: int):
    """A reference map as a program's table: (coords [B, V, 3], means,
    covariances, counts [B, V, ...]), each problem's voxels first, empty
    rows with count 0."""
    b = vm.keys[:, 0]
    V = max(int(torch.bincount(b, minlength=B).max()), 1)
    dev = vm.keys.device
    coords = torch.zeros((B, V, 3), dtype=torch.int64, device=dev)
    mean = torch.zeros((B, V, 3), dtype=vm.mean.dtype, device=dev)
    cov = torch.zeros((B, V, 3, 3), dtype=vm.cov.dtype, device=dev)
    count = torch.zeros((B, V), dtype=vm.count.dtype, device=dev)
    starts = torch.searchsorted(b, torch.arange(B, device=dev))  # keys are sorted: rows of a problem are a run
    slot = torch.arange(len(b), device=dev) - starts[b]
    coords[b, slot], mean[b, slot], cov[b, slot], count[b, slot] = vm.keys[:, 1:], vm.mean, vm.cov, vm.count
    return coords, mean, cov, count
