"""Run one cell of the benchmark of ``rivslam_tpu_torch`` on one NVIDIA card.

    python3 benchmark/run.py --workload cp.stream --seed 7 --seconds 45 --trace 0

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the traffic mix names the runner
that runs it (``benchmark/runners``). With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``benchmark/metrics``), read over a short stretch under ``torch.profiler``.
Every run checks what the timed path produced against the plain reference
(``benchmark/reference``) and prints each number compared beside its limit:
last on standard error, and last in the result line, which is the last line
of standard output.

Without a CUDA card, or with fewer than the cell asks for, the run exits
with code 2 and prints no result; so does a run in whose process the JAX
package or JAX itself was loaded.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# host threads for the few numpy and torch CPU ops: fewer threads, steadier runs
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")
os.environ["USE_FLAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             sizes: dict | None = None, control: bool = False) -> tuple[dict, dict, dict]:
    """Run one cell of the program on ``device``; returns (result, checks,
    the runner's whole output). The configurations run float32 with TF32
    off, as the program ships. ``sizes`` shrinks the traffic (rehearsals
    and tests); ``control`` also reads the control's numbers at the checked
    steps (``benchmark/readings.py``)."""
    from benchmark import harness

    cell = harness.load_cell(workload)
    harness.set_tf32(False)
    out = harness.runner(cell.traffic["runner"]).run(
        cell, seed, seconds, trace, device, harness.program_system(), t_start, sizes, control)
    checks = out["checks"]
    failed = harness.judge(checks)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(out["run"])
            if value is not None:
                metrics[m["name"]] = harness.metric(value, m["unit"])
    else:
        metrics = {m["name"]: out["metrics"][m["name"]] for m in cell.end_to_end}
    result = {
        "correct": not failed,
        "attempted": out["frames"],
        "failed": len(failed),
        "metrics": metrics,
        "device": out["device"],
    }
    tr = out["run"].get("trace")
    if trace and tr is not None:
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    return result, checks, out


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    harness.set_cache_dirs()
    import torch

    cell = harness.load_cell(args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"card: {harness.power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    result, checks, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: modules that no run may load were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 2
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
