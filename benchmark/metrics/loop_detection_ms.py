"""Loop detection: host milliseconds a keyframe that entered detection,
inside the Engine's ``engine.loop_detection`` scope over the traced frames
(scan-context match, registration verification, consistency gates)."""


def read(run):
    trace = run.get("trace")
    spans = trace.spans.get("engine.loop_detection") if trace is not None else None
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
