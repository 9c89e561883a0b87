"""The two prepares of a batch (sources, then targets: covariance
estimation): device milliseconds between CUDA events, mean over the
window's batches."""

import statistics


def read(run):
    ms = run.get("prepare_ms")
    return statistics.fmean(ms) if ms else None
