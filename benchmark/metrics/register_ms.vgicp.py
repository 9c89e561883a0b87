"""The registration after the voxel map: device milliseconds a batch of the
traced batches' device operations less the prepares' (``apdgicp.prepare``)
and the voxel map's build (``registration.voxel_map``), those two as the
profiler attributes each kernel to the scope its launch ran in: the LM,
its final step and the poses' read. The LM's kernels run inside CUDA-graph
replays on the card, which the profiler traces but attributes to no scope,
so they are taken from the whole trace, which holds the traced batches
alone. None where the program has no voxel-map span."""


def read(run):
    s = run.get("scope_device_s") or {}
    trace = run.get("trace")
    if trace is None or not trace.device_ops or not s.get("registration.voxel_map") or not run.get("traced_batches"):
        return None
    device_s = sum(end - start for _, start, end in trace.device_ops)
    after_map = device_s - s.get("apdgicp.prepare", 0.0) - s["registration.voxel_map"]
    return 1e3 * after_map / run["traced_batches"]
