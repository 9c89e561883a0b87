"""The scan-match runner: batches of frame pairs through the public,
eager scan-match entry (``apdgicp.prepare`` of the sources and of the
targets, then ``register_dispatch``), as a server registering many pairs at
once (multi-robot map merging, batched loop verification) calls it.

Set-up generates one recording of the configuration's course, its noise
drawn from the traffic's ``recording_seed``, and cuts it into ``batches`` distinct
batches of ``batch`` consecutive pairs (source frame i against target frame
i-1, padded to ``capacity``, identity guess), uploads them, and runs each
once. The window cycles through the batches in an order drawn from the
run's seed; a batch ends when its poses are read back to the host. Every
seed gets the same batches, in another order: a batch iterates until its
slowest pair has converged, so batches drawn from each seed's own noise
differ in work by up to 3.5x (cp on an H100: 207-748 ms a registration),
and the rate would follow the seed. CUDA events around the
two prepares and the registration time each stage on the device.

The check (after the window, on the program's state freed): a sample of the
window's batches, drawn from the seed before the window, against
``reference/gicp.py`` in float64, in blocks of pairs. The prepares'
covariances are compared with the reference's covariances of the same
scans. Each pair's reported error is compared with the reference's error at
the pair's own answer, and the reference's Gauss-Newton step from that
answer with the configuration's stopping rule (a step under
``transformation_epsilon`` and ``rotation_epsilon``), on the program's
prepared clouds: a registration that stopped short of converging, or
returned its guess, takes a step of many times the rule.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness, roofline
from benchmark.reference import convert, gicp
from benchmark.traffic import synthetic

SPANS = ("bench.batch",)
K1_KERNEL = "nn_gather_kernel"  # csrc/nn_gather.cu's kernel, as the trace names it
K1_FEATURES = 9  # the fast path gathers the target's xyz and 6 covariance terms


def make_batches(config: dict, traffic: dict) -> list[dict]:
    """The traffic's distinct batches, as host arrays."""
    B, nb, cap = traffic["batch"], traffic["batches"], traffic["capacity"]
    course = synthetic.simulate_sequence(seed=traffic["recording_seed"], n_frames=nb * B + 1, **config["course"])
    xyz = np.zeros((course.num_frames, cap, 3), np.float32)
    mask = np.zeros((course.num_frames, cap), bool)
    for i in range(course.num_frames):
        x, _, _, m = course.padded(i, cap)
        xyz[i], mask[i] = x, m
    return [{"src_xyz": xyz[b * B + 1:b * B + B + 1], "src_mask": mask[b * B + 1:b * B + B + 1],
             "tgt_xyz": xyz[b * B:b * B + B], "tgt_mask": mask[b * B:b * B + B]} for b in range(nb)]


def register_batch(system, reg_cfg, batch: dict, guess: torch.Tensor, device, events=None):
    """prepare, prepare, register_dispatch; the poses read back. Returns
    (the prepared sources and targets, the result, the poses on the host)."""
    if events is not None:
        events[0].record()
    src = system.apdgicp.prepare(batch["src_xyz"], batch["src_mask"], reg_cfg, device=device)
    tgt = system.apdgicp.prepare(batch["tgt_xyz"], batch["tgt_mask"], reg_cfg, device=device)
    if events is not None:
        events[1].record()
    res = system.apdgicp.register_dispatch(src, tgt, guess, reg_cfg, device=device)
    if events is not None:
        events[2].record()
    return src, tgt, res, res.T.cpu().numpy()


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, system, t_start: float,
        sizes: dict | None = None, control: bool = False) -> dict:
    """One run of a scan-match cell (see ``stream.run`` for the arguments)."""
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
    iterations: list = []
    if on_card:
        torch.cuda.synchronize(device)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    k = 0
    while time.perf_counter() - t_w0 < seconds:
        b = int(order[k % len(batches)])
        if trace and k == traced.start:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_tr0 = time.perf_counter()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if on_card else None
        with record_function("bench.batch"):
            src, tgt, res, T = register_batch(system, reg_cfg, batches[b], guess, device, events)
        iterations.append(res.iterations)
        if k in samples:
            kept[k] = {"batch": b, "T": T, **convert.clone({"source": src, "target": tgt, "error": res.error})}
        timings.append(events)
        if trace and k == traced.stop - 1:
            if on_card:
                torch.cuda.synchronize(device)
            t_tr1 = time.perf_counter()
            prof.__exit__(None, None, None)
        k += 1
    window_s = time.perf_counter() - t_w0
    if prof is not None and k < traced.stop:
        prof.__exit__(None, None, None)
        prof = None

    metrics = {
        "pairs_per_s": harness.metric(k * B / window_s, "pairs/s"),
        "setup_s": harness.metric(setup_s, "s"),
    }
    dev_info = harness.device_info(device)
    run_info: dict = {"batches": k, "trace": None}
    if on_card:
        run_info["prepare_ms"] = [e[0].elapsed_time(e[1]) for e in timings]
        run_info["register_ms"] = [e[1].elapsed_time(e[2]) for e in timings]
    its = np.asarray([int(i.max()) for i in iterations])
    print(f"scan_match: {k} batches of {B} pairs in {window_s:.3f} s; LM iterations of the slowest pair a batch "
          f"{its.min()}-{its.max()}" + (
        f"; device-event ms a batch: prepare {np.mean(run_info['prepare_ms']):.3f}, register "
        f"{np.mean(run_info['register_ms']):.3f}" if on_card else ""), flush=True)
    if prof is not None:
        tr_obj = harness.read_trace(prof, t_tr1 - t_tr0, SPANS)
        run_info["trace"] = tr_obj
        run_info["k1"] = k1_share(tr_obj, [int(order[i % len(batches)]) for i in traced], host, tr)
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


def k1_share(trace: harness.Trace, traced_batches: list[int], host: list[dict], tr: dict) -> dict | None:
    """K1's device seconds in the traced batches and the least seconds its
    launches' inputs need (``roofline.k1_work``), launch by launch: each K1
    operation belongs to the traced batch whose host span holds its start."""
    spans = sorted(h[:2] for h in trace.host_intervals if h[3] == "bench.batch")
    k1 = [(s, e) for name, s, e in trace.device_ops if K1_KERNEL in name]
    if not k1 or len(spans) != len(traced_batches):
        return None
    B, cap = tr["batch"], tr["capacity"]
    least = device = 0.0
    for s, e in k1:
        which = max((i for i, (hs, _) in enumerate(spans) if hs <= s), default=0)
        b = host[traced_batches[which]]
        ops, nbytes = roofline.k1_work(B, cap, cap, K1_FEATURES, b["src_mask"].sum(1), b["tgt_mask"].sum(1))
        least += roofline.least_time_s(ops, nbytes)[0]
        device += e - s
    return {"least_s": least, "device_s": device, "launches": len(k1)}


def reference_prepare(ref, reg_cfg, batch: dict, block: int, dtype, device) -> tuple[list, list]:
    """The frozen reference's prepares of one host batch, ``block`` pairs at
    a time: ([source blocks], [target blocks]) of prepared clouds (the
    control's, in the program's place)."""
    srcs, tgts = [], []
    for s in range(0, len(batch["src_xyz"]), block):
        part = {k: torch.as_tensor(v[s:s + block]).to(device) for k, v in batch.items()}
        part = {k: v.to(dtype) if v.is_floating_point() else v for k, v in part.items()}
        srcs.append(ref.apdgicp.prepare(part["src_xyz"], part["src_mask"], reg_cfg, device=device))
        tgts.append(ref.apdgicp.prepare(part["tgt_xyz"], part["tgt_mask"], reg_cfg, device=device))
    return srcs, tgts


def reference_covariances(reg_cfg, xyz: np.ndarray, mask: np.ndarray, block: int, device) -> np.ndarray:
    """``reference.gicp``'s float64 covariances of a host batch of scans,
    ``block`` scans at a time."""
    return np.concatenate([
        gicp.rbf_covariances(torch.as_tensor(xyz[s]).to(device), torch.as_tensor(mask[s]).to(device),
                             reg_cfg.rbf_kernel_width, reg_cfg.rbf_max_dist).cpu().numpy()
        for s in gicp.blocks(len(xyz), block)])


def cov_gaps(got_cov: np.ndarray, want_cov: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Each valid point's relative gap of covariance, |got - want|_F / |want|_F."""
    d = np.linalg.norm(got_cov - want_cov, axis=(-2, -1))
    return (d / np.maximum(np.linalg.norm(want_cov, axis=(-2, -1)), 1e-30))[mask]


def _blocks(cloud, block: int) -> list:
    n = cloud.xyz.shape[0]
    return [type(cloud)(**{f: getattr(cloud, f)[s] for f in ("xyz", "mask", "cov")}) for s in gicp.blocks(n, block)]


def check(cell, host: list[dict], kept: dict, device, tr: dict, control: bool = False):
    """The sampled batches against the reference in float64 on the same
    pairs (``reference/gicp.py``). Returns (gaps, the control's gaps, or
    None without ``control``); ``gaps["items"]`` holds each checked pair's
    numbers. The prepares' covariances are compared with the reference's of
    the same scans; each pair's reported error with the error at its answer,
    and the Gauss-Newton step from its answer with the configuration's
    stopping rule, on the program's prepared clouds."""
    harness.set_tf32(False)
    reg_cfg = harness.engine_config(cell.config["engine"], harness.reference_system().config).registration
    f64, block = torch.float64, tr["check_block"]
    sides = ("program", "control") if control else ("program",)
    cov = {s: [] for s in sides}
    err = {s: [] for s in sides}
    step = {s: [] for s in sides}
    for k in sorted(kept):
        c = kept[k]
        batch = host[c["batch"]]
        masks = (batch["src_mask"], batch["tgt_mask"])
        want_cov = [reference_covariances(reg_cfg, batch[f"{side}_xyz"], batch[f"{side}_mask"], block, device)
                    for side in ("src", "tgt")]
        for side, got_cov in enumerate((c["source"].cov, c["target"].cov)):
            cov["program"].append(cov_gaps(got_cov.double().cpu().numpy(), want_cov[side], masks[side]))
        if control:
            ref = harness.reference_system()
            with harness.tf32():
                ctrl_prep = reference_prepare(ref, reg_cfg, batch, block, torch.float32, device)
            for side, got in enumerate(ctrl_prep):
                got_cov = np.concatenate([p.cov.double().cpu().numpy() for p in got])
                cov["control"].append(cov_gaps(got_cov, want_cov[side], masks[side]))
        for s, (src, tgt) in zip(gicp.blocks(len(c["T"]), block), zip(_blocks(c["source"], block),
                                                                         _blocks(c["target"], block))):
            src64, tgt64 = (convert.to_reference(x, f64, device) for x in (src, tgt))
            answers = {"program": (torch.as_tensor(c["T"][s]).to(device, f64), c["error"][s])}
            if control:
                guess = torch.eye(4, dtype=torch.float32, device=device).expand(len(c["T"][s]), 4, 4).contiguous()
                with harness.tf32():
                    cs, ct = (convert.to_reference(x, torch.float32, device) for x in (src, tgt))
                    res = ref.apdgicp.register_dispatch(cs, ct, guess, reg_cfg, device=device)
                answers["control"] = (res.T.to(f64), res.error)
            problem = harness.registration_problem(reg_cfg, src64, tgt64)
            for side, (T, reported) in answers.items():
                err[side].append(harness.band_gap(reported, *harness.registration_error(
                    reg_cfg, src64, tgt64, T, band=harness.BAND)))
                step[side].append(problem.step_units(T).cpu().numpy())

    def stats(side: str) -> dict:
        cv, er, st = (np.concatenate(x[side] or [[np.nan]]) for x in (cov, err, step))
        return {"cov_gap_p50": float(np.median(cv)), "cov_gap_p90": float(np.percentile(cv, 90)),
                "cov_gap_max": float(cv.max()), "reg_error_gap_p50": float(np.median(er)),
                "reg_error_gap_p75": float(np.percentile(er, 75)), "reg_error_gap_p90": float(np.percentile(er, 90)),
                "reg_error_gap_max": float(er.max()), "reg_step_p50": float(np.median(st)),
                "reg_step_p90": float(np.percentile(st, 90)), "reg_step_max": float(st.max())}

    gaps = {**stats("program"), "pairs_checked": int(sum(len(e) for e in err["program"]))}
    ctrl = stats("control") if control else None
    print(f"scan_match check: {gaps}" + (f"; control {ctrl}" if control else ""), flush=True)
    gaps["items"] = {"batches": [int(kept[k]["batch"]) for k in sorted(kept)], "slots": sorted(int(k) for k in kept),
                     "error_gap": np.concatenate(err["program"] or [[]]).tolist(),
                     "step": np.concatenate(step["program"] or [[]]).tolist(),
                     "cov_gap_p50_by_batch": [float(np.median(np.concatenate(cov["program"][2 * j:2 * j + 2])))
                                              for j in range(len(kept))]}
    return gaps, ctrl
