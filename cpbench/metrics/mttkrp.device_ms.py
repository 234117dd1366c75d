"""Device ms a sweep of the operations launched inside
``distributed.local_mttkrp`` (traced run)."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not tr["layer_device_s"].get("mttkrp"):
        return None
    return 1e3 * tr["layer_device_s"]["mttkrp"] / tr["sweeps"]
