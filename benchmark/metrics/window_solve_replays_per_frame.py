"""CUDA-graph replays of the window solve (``Engine.graphs.solve.replays``:
outer iterations plus the final chi2) over the window's frames."""


def read(run):
    replays = run.get("replays", {}).get("window_solve")
    if replays is None or not run.get("frames"):
        return None
    return replays / run["frames"]
