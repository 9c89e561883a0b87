"""The control fails the check, and the program passes it, on the card at
each cell's own size: at every checked step the plain reference takes the
program's place one precision below the configurations' float32 with TF32
off, that is with TF32 on, and its numbers break at least one of the cell's
limits. Card only (marked ``cuda``; skips without a card):

    python -m pytest -o addopts="" -p no:cacheprovider -m cuda benchmark/tests/test_bench_control.py

``benchmark/readings.py`` gives the same readings over many seeds; the
limits' readings are in PERF.md.
"""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, run  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    harness.set_cache_dirs()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload,seconds", [("cp.scan_match", 6), ("cp.stream", 10), ("garden.stream", 14)])
def test_control_fails_and_program_passes(card, workload, seconds):
    cell = harness.load_cell(workload)
    result, checks, out = run.run_cell(workload, 2**33 + 17, seconds, False, card, time.perf_counter(),
                                       control=True)
    assert result["correct"], checks
    failed = harness.judge(harness.checks_of(out["control_gaps"], cell.limits))
    assert failed, out["control_gaps"]
