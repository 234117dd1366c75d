"""The MTTKRP's share of its roofline, %: the sweep's least time
(``leasttime.py``) over the device time of the MTTKRP layer a sweep."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not run["least_s"] or not tr["layer_device_s"].get("mttkrp"):
        return None
    per_sweep = tr["layer_device_s"]["mttkrp"] / tr["sweeps"]
    return 100.0 * run["least_s"] / per_sweep
