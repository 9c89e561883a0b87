"""Odometry (scan-to-scan or scan-to-map registration): host milliseconds a traced frame inside the Engine's
``engine.odometry`` scope (``record_function``; the stage ends in a host read,
so its host time covers its device work)."""


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("traced_frames") or "engine.odometry" not in trace.spans:
        return None
    return 1e3 * sum(trace.spans["engine.odometry"]) / run["traced_frames"]
