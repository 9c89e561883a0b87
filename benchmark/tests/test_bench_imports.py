"""The import guard: the harness's modules, run in a fresh process at a CPU
rehearsal size (every cell, the checks included), load no module whose
top-level name is ``jax`` or ``rivslam_tpu`` (compared whole: the port,
``rivslam_tpu_torch``, is allowed), and open no file under ``tests/``, nor
``bench.py``, nor anything under ``bench_assets/``.

    python -m pytest benchmark/tests/test_bench_imports.py -q -p no:cacheprovider
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REHEARSAL = r"""
import json, os, sys, time
t0 = time.perf_counter()
root = sys.argv[1]
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0])) if event == "open" and args
                 and isinstance(args[0], (str, bytes, os.PathLike)) else None)
sys.path.insert(0, root)
import torch
torch.set_num_threads(2)
from benchmark import harness, run
sizes = {
    "stream": dict(capacity=256, warmup_min_frames=2, warmup_until_loop=False, warmup_max_frames=2,
                   max_frames_per_s=2, check_span=2, check_frames=1, trace_start=0, trace_frames=1),
    "scan_match": dict(batch=2, batches=1, capacity=128, check_span=1, check_batches=1, check_block=2,
                       trace_start=0, trace_batches=1),
}
results = {}
for workload in ("cp.stream", "garden.stream", "cp.scan_match"):
    cell = harness.load_cell(workload)
    result, checks, _ = run.run_cell(workload, 2**35 + 1, 0.5, True, torch.device("cpu"), t0,
                                  sizes=sizes[cell.traffic["runner"]])
    results[workload] = sorted(result["metrics"])
loaded = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"loaded": loaded, "opened": opened, "results": results}))
"""


def test_no_jax_and_no_test_data():
    proc = subprocess.run([sys.executable, "-c", REHEARSAL, ROOT], capture_output=True, text=True,
                          timeout=900, env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("jax", "jaxlib", "flax", "rivslam_tpu"):
        assert name not in out["loaded"], f"{name} was loaded"
    assert "rivslam_tpu_torch" in out["loaded"]  # the system under test ran
    forbidden = [os.path.join(ROOT, "tests") + os.sep, os.path.join(ROOT, "bench_assets") + os.sep]
    for path in out["opened"]:
        full = os.path.abspath(path)
        assert not any(full.startswith(f) for f in forbidden), full
        assert full != os.path.join(ROOT, "bench.py"), full
    assert set(out["results"]) == {"cp.stream", "garden.stream", "cp.scan_match"}
