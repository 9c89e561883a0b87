"""K1's share of its roofline in the traced batches, in percent: the least
time one H100 needs for the work of each K1 launch's inputs
(``benchmark/roofline.py``) over K1's device time in the trace."""


def read(run):
    k1 = run.get("k1")
    if not k1 or k1["device_s"] <= 0:
        return None
    return 100.0 * k1["least_s"] / k1["device_s"]
