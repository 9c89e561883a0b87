"""The global keyframe-graph solve on loop frames: the median of the
Engine's own ``graph_opt`` timer samples (host clock around the solve,
which ends in host reads) over the whole window of the traced run."""

import statistics


def read(run):
    samples = run.get("graph_opt_s")
    if not samples:
        return None
    return 1e3 * statistics.median(samples)
