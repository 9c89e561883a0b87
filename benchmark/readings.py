"""The readings behind the limits of a cell's correctness check: for each
seed, the numbers the check reads for the program (the lower readings) and
for the control (the upper readings), in one process.

    python3 benchmark/readings.py --workload cp.stream --seconds 8 \\
        --seeds 11 12 13 [--out readings.jsonl] [--no-control] \\
        [--fault none registration_returns_guess] [--sizes '{"check_frames": 120}']

Each run is a whole run of the cell (set-up, window, check) at the cell's
own sizes; a short window is enough where it reaches every sampled answer.
The check follows the program step by step from its own state, and at each
checked step the control takes the program's place: the plain reference
computed one precision below the configurations' float32 with TF32 off,
that is with TF32 on, from the same inputs. One JSON line a run: the seed,
the program's and the control's numbers (each checked frame's,
registration's and solve's under ``items``), the end-to-end metrics. With
``--fault`` the program runs with that fault of ``benchmark/faults.py``
planted; ``--sizes`` overrides traffic parameters, such as the sample the
check reads. The benchmark's own runs plant no fault and do not run the
control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--no-control", action="store_true", help="read the program's numbers only")
    ap.add_argument("--fault", nargs="+", default=["none"],
                    help="faults of benchmark/faults.py to plant, one after another ('none': the program as it is)")
    ap.add_argument("--sizes", default=None, help="traffic parameters to override, as a JSON object")
    args = ap.parse_args(argv)

    from benchmark import harness

    harness.set_cache_dirs()
    import torch

    from benchmark import faults, run

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)  # the context, before the peak is reset
    print(f"card: {harness.power_limit()}; torch {torch.__version__}", flush=True)
    for fault, seed in [(f, s) for f in args.fault for s in args.seeds]:
        fault = None if fault == "none" else fault
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with faults.planted(fault):
            result, checks, out = run.run_cell(args.workload, seed, args.seconds, False, device, t0,
                                               sizes=json.loads(args.sizes) if args.sizes else None,
                                               control=not args.no_control)
        line = {"workload": args.workload, "seed": seed, "fault": fault, "correct": result["correct"],
                "failed": harness.judge(checks), "gaps": out["gaps"], "control": out.get("control_gaps"),
                "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - t0}
        text = json.dumps(line)
        short = {**line, "gaps": {k: v for k, v in line["gaps"].items() if k != "items"}}
        print(json.dumps(short), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
