"""Shared set-up for the port's test files (tests/test_torch_*.py), which
each import this module.

1. One torch intra-op thread per test process. The tests run many small
   tensors in several pytest-xdist workers at once, beside XLA's own
   pools; torch's default of a thread per core makes the workers fight
   for the cores (one loop-course test: 112 s alone by default, 79 s with
   one thread; several times longer under six workers). Child processes
   that must reduce in the same order (the gloo ranks of
   tests/test_torch_dist.py) take the same count, ``THREADS``.

2. ``shared(request, name, compute)``: a heavy module fixture's result,
   computed once per pytest session and shared by every xdist worker. The
   first worker to get there takes an ``fcntl`` lock on a file in the
   session's temporary directory (the parent of each worker's basetemp,
   which all workers of one session share), computes the value and
   pickles it there; the others wait on the lock and load it. Without
   xdist the value is computed in the process. The value must pickle:
   the fixtures return what their tests read (numpy arrays, numbers and
   plain containers), not live engines.

3. ``release_xla_executables``, an autouse fixture each test file imports:
   before a port test, when the process holds more than
   ``XLA_MAPS_LIMIT`` memory mappings, it clears JAX's caches. Every
   compiled XLA:CPU program keeps its own mappings (a JAX engine test
   leaves thousands), an xdist worker runs many such tests, and a process
   that reaches the kernel's limit (``vm.max_map_count``, 65530 by
   default) dies inside XLA on its next compile or cache read, failing
   whatever test it is running. Clearing costs only a recompile (mostly a
   read of the persistent compilation cache).
"""

from __future__ import annotations

import fcntl
import gc
import os
import pickle
import sys

import pytest
import torch

THREADS = 1
torch.set_num_threads(THREADS)
# well under vm.max_map_count: the JAX tests between two port tests of one
# worker add up to ~36,000 mappings
XLA_MAPS_LIMIT = 20_000


@pytest.fixture(autouse=True)
def release_xla_executables():
    jax = sys.modules.get("jax")
    if jax is not None:
        with open("/proc/self/maps") as f:
            if sum(1 for _ in f) > XLA_MAPS_LIMIT:
                jax.clear_caches()
                gc.collect()
    yield


def shared(request, name: str, compute):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    root = request.getfixturevalue("tmp_path_factory").getbasetemp().parent
    path = root / f"torch_shared_{name}.pkl"
    with open(root / f"torch_shared_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = compute()
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
