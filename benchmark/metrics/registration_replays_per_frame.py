"""CUDA-graph replays of the odometry's registration (``Engine.reg_graphs
.replays``: outer LM iterations plus final steps) over the window's frames."""


def read(run):
    replays = run.get("replays", {}).get("registration")
    if replays is None or not run.get("frames"):
        return None
    return replays / run["frames"]
