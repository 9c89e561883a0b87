"""The target's voxel map (``registration.voxel_map``, the span around its
build in ``register_dispatch``): device milliseconds a batch of the kernels
launched inside the span, as the profiler attributes each kernel to the
scope its launch ran in, over the traced batches. None where the program
has no such span."""


def read(run):
    s = (run.get("scope_device_s") or {}).get("registration.voxel_map", 0.0)
    if not s or not run.get("traced_batches"):
        return None
    return 1e3 * s / run["traced_batches"]
