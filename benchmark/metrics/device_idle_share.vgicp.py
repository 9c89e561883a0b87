"""The device's idle share over the traced stretch, in percent: 100 x (1 -
the union of the device operations' intervals / the stretch's wall time).
Operations on several streams that overlap count once."""


def read(run):
    trace = run.get("trace")
    if trace is None or trace.wall_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.wall_s)
