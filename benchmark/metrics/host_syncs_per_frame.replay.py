"""Host syncs a replayed frame: the program tracer's ``host_syncs`` under
``engine.replay`` (every synchronizing CUDA call the sync debug mode
reports, inside the span or a span within it) over the window's frames.
None where the program has no ``engine.replay`` span."""


def read(run):
    if not run.get("engine_replay_spans") or not run.get("frames"):
        return None
    return run["host_syncs_replay"] / run["frames"]
