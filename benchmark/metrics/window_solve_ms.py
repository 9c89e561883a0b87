"""The backend's sliding-window solve: host milliseconds a traced frame inside the Engine's
``backend.window_solve`` scope (``record_function``; the stage ends in a host read,
so its host time covers its device work)."""


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("traced_frames") or "backend.window_solve" not in trace.spans:
        return None
    return 1e3 * sum(trace.spans["backend.window_solve"]) / run["traced_frames"]
