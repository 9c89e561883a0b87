"""Preprocessing (filters, REVE, voxel grid, floor, covariances): host milliseconds a traced frame inside the Engine's
``engine.preprocess`` scope (``record_function``; the stage ends in a host read,
so its host time covers its device work)."""


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("traced_frames") or "engine.preprocess" not in trace.spans:
        return None
    return 1e3 * sum(trace.spans["engine.preprocess"]) / run["traced_frames"]
