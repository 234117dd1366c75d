"""Device ms a sweep of the operations launched inside
``distributed.device_remap`` (traced run)."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not tr["layer_device_s"].get("remap"):
        return None
    return 1e3 * tr["layer_device_s"]["remap"] / tr["sweeps"]
