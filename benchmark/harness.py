"""What every cell of the benchmark shares: finding a cell's parts by name,
building the engine configuration from its data file, reading the profiler's
trace, and printing the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its parts are
found by name, so a later cell adds files and entries and edits none:

- the configuration: ``benchmark/configs/<config>.json``;
- the traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``runner``
  names the general runner that reads it (``benchmark/runners/<runner>.py``);
- the limits of its correctness check: ``benchmark/limits/<workload>.json``;
- each per-layer metric: a reader in ``benchmark/metrics/<metric>.py`` with
  ``read(run) -> float | None`` (None where the run has nothing to read).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import types

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# the harness's caches, each at a fixed path inside the checkout
CACHE_DIRS = {
    "CUDA_CACHE_PATH": os.path.join(ROOT, ".bench_cache", "nv"),
    "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, ".bench_cache", "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(ROOT, ".bench_cache", "triton"),
}
# top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rivslam_tpu")


def program_system() -> types.SimpleNamespace:
    """The system under test: the port's modules the runners call."""
    base = "rivslam_tpu_torch"
    return types.SimpleNamespace(
        pipeline=importlib.import_module(f"{base}.pipeline"),
        config=importlib.import_module(f"{base}.core.config"),
        pointcloud=importlib.import_module(f"{base}.core.pointcloud"),
        apdgicp=importlib.import_module(f"{base}.frontend.apdgicp"),
        block_schur=importlib.import_module(f"{base}.loop.block_schur"),
    )


def reference_system() -> types.SimpleNamespace:
    """The frozen copy of the port's plain path (``benchmark/reference/plain``):
    the preprocessing and the window backend that the stream check runs
    from the program's state, and the prepare and registration that the
    control runs in the program's place."""
    base = "benchmark.reference.plain"
    return types.SimpleNamespace(
        config=importlib.import_module(f"{base}.core.config"),
        pointcloud=importlib.import_module(f"{base}.core.pointcloud"),
        prng=importlib.import_module(f"{base}.core.prng"),
        frame=importlib.import_module(f"{base}.frame"),
        apdgicp=importlib.import_module(f"{base}.frontend.apdgicp"),
        slam=importlib.import_module(f"{base}.backend.slam"),
    )


def set_tf32(on: bool) -> None:
    """TF32 for float32 matrix products (cuBLAS) and convolutions (cuDNN)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def tf32():
    """TF32 on inside the block: the control's precision, one below the
    configurations' float32 with TF32 off."""
    set_tf32(True)
    try:
        yield
    finally:
        set_tf32(False)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    spec: dict  # the workloads entry
    config: dict  # benchmark/configs/<config>.json
    traffic: dict  # benchmark/traffic/<traffic>.json
    limits: dict  # benchmark/limits/<name>.json
    end_to_end: list  # the end_to_end entries this cell reports
    per_layer: list  # the per_layer entries this cell reports


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (or of ``bench``)."""
    bench = bench if bench is not None else read_json(os.path.join(ROOT, "BENCHMARK.json"))
    specs = {w["name"]: w for w in bench["workloads"]}
    if workload not in specs:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(specs)}")
    spec = specs[workload]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in reported and _reports(m, workload)]
    return Cell(
        name=workload, spec=spec,
        config=read_json(os.path.join(BENCH, "configs", f"{spec['config']}.json")),
        traffic=read_json(os.path.join(BENCH, "traffic", f"{spec['traffic']}.json")),
        limits=read_json(os.path.join(BENCH, "limits", f"{workload}.json")),
        end_to_end=e2e, per_layer=per_layer,
    )


def runner(name: str):
    """The general runner ``benchmark/runners/<name>.py``."""
    return importlib.import_module(f"benchmark.runners.{name}")


def metric_reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def engine_config(sections: dict, config_module):
    """``config_module.EngineConfig`` with every field taken from
    ``sections`` ({section: {field: value}}): a field missing from the data,
    or one the configuration does not have, raises. Strings stand for
    floats that JSON cannot hold ("inf"); lists become tuples."""
    top = config_module.EngineConfig
    kwargs = {}
    names = {f.name for f in dataclasses.fields(top)}
    if set(sections) != names:
        raise ValueError(f"engine sections {sorted(sections)} are not EngineConfig's {sorted(names)}")
    for f in dataclasses.fields(top):
        cls = type(f.default)
        data = sections[f.name]
        fields = {g.name: g for g in dataclasses.fields(cls)}
        if set(data) != set(fields):
            raise ValueError(f"{f.name}: fields {sorted(set(data) ^ set(fields))} differ from the configuration's")
        vals = {}
        for k, v in data.items():
            default = fields[k].default
            if isinstance(default, float) and isinstance(v, str):
                v = float(v)
            elif isinstance(default, tuple):
                v = tuple(v)
            vals[k] = v
        kwargs[f.name] = cls(**vals)
    return top(**kwargs)


def set_cache_dirs() -> None:
    """Point every build and kernel cache at its directory in the checkout."""
    for key, path in CACHE_DIRS.items():
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
    }


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


# ---- the profiler's trace ---------------------------------------------------


@dataclasses.dataclass
class Trace:
    """What the harness reads from one traced stretch: host spans by name
    (seconds, one entry per occurrence), device operations (name, start,
    end in seconds), the stretch's wall seconds, and the host spans' own
    intervals for labelling the device's idle gaps."""

    spans: dict
    device_ops: list
    wall_s: float
    host_intervals: list  # (start, end, depth, name) of user spans

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the operations' intervals (overlapping streams count once)."""
        return sum(e - s for s, e in self._union())

    def _union(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def top_device_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time between operations, summed by the
        innermost host span open at the middle of each gap."""
        import numpy as np

        busy = np.asarray(self._union()).reshape(-1, 2)
        if len(busy) < 2:
            return []
        length = busy[1:, 0] - busy[:-1, 1]
        mid = 0.5 * (busy[1:, 0] + busy[:-1, 1])
        label = np.full(len(mid), -1)
        spans = sorted(range(len(self.host_intervals)), key=lambda k: self.host_intervals[k][2])
        for k in spans:  # deeper spans overwrite the spans around them
            s, e = self.host_intervals[k][:2]
            label[np.searchsorted(mid, s, "left"):np.searchsorted(mid, e, "right")] = k
        by: dict[str, float] = {}
        for k, g in zip(label, length):
            name = self.host_intervals[k][3] if k >= 0 else "outside any span"
            by[name] = by.get(name, 0.0) + float(g)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read_trace(prof, wall_s: float, span_names) -> Trace:
    """The harness's reading of a ``torch.profiler.profile`` over a stretch
    of ``wall_s`` seconds. User spans (``record_function``) may also appear
    on the device's timeline as annotations: they are not operations."""
    import torch

    span_names = set(span_names)
    spans: dict[str, list[float]] = {}
    host, ops = [], []
    events = prof.events()
    annotations = {e.name for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU and e.name in span_names}
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CPU:
            if e.name in span_names:
                spans.setdefault(e.name, []).append(t - s)
                host.append((s, t, 0, e.name))
        elif e.name not in annotations and not getattr(e, "is_user_annotation", False):
            ops.append((e.name, s, t))
    # nesting depth of each host span, for the innermost one at a gap
    host.sort(key=lambda h: (h[0], -h[1]))
    stack, nested = [], []
    for s, t, _, name in host:
        while stack and stack[-1] < s:
            stack.pop()
        nested.append((s, t, len(stack), name))
        stack.append(t)
    return Trace(spans=spans, device_ops=ops, wall_s=wall_s, host_intervals=nested)


# ---- the result line ---------------------------------------------------------


def metric(value, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def checks_of(gaps: dict, limits: dict) -> dict:
    """The compared numbers: every gap that the cell's limits name, beside
    its limit (a gap the run could not read, such as a solve's in a window
    without one, is left out)."""
    return {name: {"value": value, "limit": limits[name]} for name, value in gaps.items() if name in limits}


BAND = 1e-4  # of the squared correspondence limit: a point on it may go either way


def registration_problem(cfg, source, target):
    """``reference.gicp``'s float64 problem over prepared clouds (any
    object with ``xyz``, ``mask`` and ``cov``) under the registration
    configuration ``cfg``."""
    from benchmark.reference import gicp

    return gicp.Problem(source.xyz, source.mask, source.cov, target.xyz, target.mask, target.cov, cfg)


def registration_error(cfg, source, target, T, band: float = 0.0):
    """The error [B] at the transforms ``T`` [B,4,4] by ``reference.gicp``,
    what a registration reports for its answer. With ``band``, a pair
    (lower, upper): the error with the squared correspondence distance
    limit moved down and up by ``band`` of itself, the range a point
    sitting on the limit may put the reported error in."""
    if not band:
        return registration_problem(cfg, source, target).error(T)
    d2 = cfg.max_correspondence_distance ** 2
    return tuple(registration_problem(dataclasses.replace(
        cfg, max_correspondence_distance=math.sqrt(d2 * (1.0 + s * band))), source, target).error(T)
        for s in (-1.0, 1.0))


def band_gap(got, lower, upper) -> "np.ndarray":
    """Each entry's distance from [lower, upper], relative to upper."""
    import numpy as np

    g, lo, hi = (np.asarray(x.double().cpu().numpy() if hasattr(x, "cpu") else x, np.float64)
                 for x in (got, lower, upper))
    return np.maximum(np.maximum(lo - g, g - hi), 0.0) / np.maximum(np.abs(hi), 1e-30)


def judge(checks: dict) -> list[str]:
    """The checks that fail: a gap over its limit, a count under its
    (``at_least``) limit, or a number that is not finite."""
    def ok(c):
        if not finite(c["value"]):
            return False
        return c["value"] >= c["limit"] if c.get("at_least") else c["value"] <= c["limit"]

    return [name for name, c in checks.items() if not ok(c)]


def emit(result: dict, checks: dict) -> None:
    """Print the checks' numbers beside their limits as the last lines on
    standard error, and the result as the last line of standard output, its
    ``checks`` key last."""
    for name, c in checks.items():
        bound = "at least" if c.get("at_least") else "at most"
        print(f"check {name}: {c['value']!r}, limit {bound} {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)


def finite(x) -> bool:
    return x is not None and math.isfinite(float(x))
