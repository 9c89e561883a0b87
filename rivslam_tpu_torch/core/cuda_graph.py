"""Fixed-shape pieces of the engine as CUDA graphs (card only).

The reference runs its per-frame backend as one compiled XLA program. The
port's counterpart on the card is a CUDA graph: a function of fixed-shape
tensors is captured once, and every frame copies its inputs into the
graph's static input tensors and replays it, with no host work per kernel.
The CPU runs the same functions eagerly (the tests do), so a graph replays
exactly what the CPU path computes.

A capture that fails raises: there is no eager fallback on the card.

The kernel wrappers (K1-K3) count their launches on the host, so a launch
inside a graph is counted per replay: the launches a piece made while it
was captured are credited to each wrapper at every replay, and the set-up
(warm-up and capture) leaves the counts as it found them.

Nor may a capture meet Python's cycle collector: on the card, freeing
dead reference cycles in the middle of a capture was seen to invalidate it
(the window solve's capture at Engine construction, after earlier Engines
and failed captures had become garbage; which freed object does it is not
known). torch no longer collects before a capture unless
``torch.compiler.config.force_cudagraph_gc`` is set, so a capture collects
first and holds the collector off until it ends (``_no_gc``).

With the tracer on (``eval/timing``) a capture is a ``graph.capture``
span, counted under ``graph_captures`` and timed under
``graph_capture_ms``, and each replay counts under ``graph_replays``, by
the graph's name.

``LOCK`` makes a capture safe beside a second thread (the Engine's
asynchronous loop worker). A capture takes it for its warm-up and capture,
and the worker for each job: under the default capture mode any CUDA call
of another thread that could touch a capturing stream (a host read, an
allocation, a synchronize) fails the capture or lands in it, and the
capture's pinned linalg library (``cusolver``) is a process-wide setting a
concurrent solve would read. With the lock neither can happen, and no
worker launch is counted, or lost, while a capture restores the counts.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

from rivslam_tpu_torch.eval import timing
from rivslam_tpu_torch.ops import cuda_build, nn_argmin, nn_corr, nn_gather

# the wrappers whose ``launches`` a replay credits
COUNTED = (nn_gather.fused_gather, nn_corr.fused_correspondence, nn_argmin.nearest_neighbor)
# held by every capture and by every job of the loop worker
LOCK = threading.RLock()


@contextlib.contextmanager
def cusolver():
    """Pin torch.linalg to cuSOLVER. The small factorizations of the window
    solve (Cholesky, LU) may otherwise take a MAGMA path that synchronizes
    with the host, which a capture refuses; cuSOLVER's do not."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


@contextlib.contextmanager
def _no_gc():
    """Collect the dead reference cycles now, then keep the cycle collector
    off until the block ends."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class Graphed:
    """``fn(*inputs)`` captured as one CUDA graph over the given static input
    tensors (kept as they are, so several graphs may share them).

    ``load`` copies new values into the inputs, ``replay`` runs the graph and
    returns ``fn``'s outputs, whose tensors are the graph's own: each replay
    overwrites them. ``fn`` may also write into its inputs in place (a
    loop's carry). ``replays`` counts the replays; ``launches`` holds the
    kernel launches of one replay, by wrapper."""

    WARMUP = 2

    def __init__(self, name: str, fn, inputs: list[torch.Tensor]):
        if not inputs or any(t.device.type != "cuda" for t in inputs):
            raise ValueError(f"{name}: a CUDA graph needs CUDA input tensors")
        self.name = name
        self.inputs = inputs
        self.replays = 0
        dev = inputs[0].device
        with LOCK, timing.span(timing.CAPTURE_SPAN):
            t0 = time.perf_counter()
            self._capture(fn, dev)
            timing.count("graph_captures", name)
            timing.count("graph_capture_ms", name, 1e3 * (time.perf_counter() - t0))

    def _capture(self, fn, dev) -> None:
        inputs, name = self.inputs, self.name
        counts = [fn_.launches for fn_ in COUNTED]
        try:
            with torch.cuda.device(dev), cusolver():
                # warm-up on a side stream, so that lazy initializations
                # (cuBLAS/cuSOLVER handles, workspaces) happen outside the capture
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for _ in range(self.WARMUP):
                        fn(*inputs)
                torch.cuda.current_stream(dev).wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                warm = [fn_.launches for fn_ in COUNTED]
                with _no_gc(), torch.cuda.graph(self.graph):
                    self.outputs = fn(*inputs)
                captured = [fn_.launches - w for fn_, w in zip(COUNTED, warm)]
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {name} failed: {e}") from e
        finally:
            for fn_, n in zip(COUNTED, counts):
                fn_.launches = n
        self.launches = {fn_: n for fn_, n in zip(COUNTED, captured) if n}

    def load(self, *values) -> None:
        if len(values) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(values)} inputs for {len(self.inputs)} static inputs")
        for dst, src in zip(self.inputs, values):
            dst.copy_(src)

    def replay(self):
        self.graph.replay()
        self.replays += 1
        timing.count("graph_replays", self.name)
        for fn, n in self.launches.items():
            cuda_build.count_launch(fn, n)
        return self.outputs
