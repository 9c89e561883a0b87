"""``register_dispatch`` of a batch: device milliseconds between CUDA
events, mean over the window's batches."""

import statistics


def read(run):
    ms = run.get("register_ms")
    return statistics.fmean(ms) if ms else None
