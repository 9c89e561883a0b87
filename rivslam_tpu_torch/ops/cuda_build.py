"""Build the port's hand-written CUDA kernels at first use.

Each kernel source in ``csrc/`` is compiled by one ``nvcc`` call into a
shared library with a plain C interface, for sm_90a, and loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds.
Libraries go into the gitignored ``rivslam_tpu_torch/_build/``, keyed by a
hash of the source, the local headers it includes and the flags, so a
changed source is never served a stale library. nvcc writes to a temporary name that is renamed into place:
a concurrent or interrupted build never leaves a partial library behind,
and no lock is needed. Builds of different sources may run at once (from
threads: the nvcc subprocess releases the interpreter).

Each kernel wrapper counts its launches with ``count_launch``: into
``launches``, or into ``worker_launches`` when the launch comes from a
thread inside ``counting_as_worker`` (the Engine's asynchronous loop
worker), under one lock, so that two threads never lose a count.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Callable

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600
MAX_BLOCKS_Y = 65535  # the kernels put problems on grid.y (K1) or grid.z (K2, K3)


@dataclasses.dataclass(frozen=True)
class Build:
    """A built and loaded kernel library."""

    path: str
    seconds: float  # wall time of the nvcc call, 0.0 when already built
    ptxas: tuple[str, ...]  # nvcc's -Xptxas -v report (registers, smem, spills)
    lib: ctypes.CDLL


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found under {cuda_home}/bin or on PATH")
    return found


def library_path(source: str) -> str:
    """Where the library for ``source`` and the current flags lives."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        text = f.read()
    h.update(text)
    for header in re.findall(rb'#include "([^"]+)"', text):
        with open(os.path.join(os.path.dirname(source), header.decode()), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def build(source: str, declare: Callable[[ctypes.CDLL], None]) -> Build:
    """Compile ``source`` (once per source hash), load it, and let
    ``declare`` set the argtypes/restype of its exported functions."""
    path = library_path(source)
    seconds, ptxas = 0.0, ()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)
        ptxas = tuple(
            ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "ptxas" in ln or "spill" in ln
        )
    lib = ctypes.CDLL(path)
    declare(lib)
    return Build(path=path, seconds=seconds, ptxas=ptxas, lib=lib)


def check_launch(batch: int, float32: dict, other: dict) -> None:
    """Raise on what a kernel cannot take: ``float32`` inputs of another
    dtype, non-contiguous inputs, more problems than the grid holds."""
    for name, t in float32.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
    for name, t in {**float32, **other}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if batch > MAX_BLOCKS_Y:
        raise ValueError(f"B={batch} exceeds the kernel's {MAX_BLOCKS_Y} problems")


_SM_COUNTS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count (read once per device)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


def launch(fn, device: torch.device, *args) -> None:
    """Call a library's launch function on ``device``'s current stream;
    raise if the launch was refused (it returns the cudaError_t). The device
    is made current only when it is not already."""
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {err}")


_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()


def in_worker() -> bool:
    """Whether this thread is inside ``counting_as_worker`` (the Engine's
    loop worker)."""
    return getattr(_THREAD, "worker", False)


def count_launch(fn, n: int = 1) -> None:
    """Add ``n`` launches to wrapper ``fn``'s count: ``fn.worker_launches``
    on a thread inside ``counting_as_worker``, else ``fn.launches``."""
    with _COUNT_LOCK:
        if in_worker():
            fn.worker_launches += n
        else:
            fn.launches += n


@contextlib.contextmanager
def counting_as_worker():
    """Count this thread's launches as the loop worker's."""
    _THREAD.worker = True
    try:
        yield
    finally:
        _THREAD.worker = False
