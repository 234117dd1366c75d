"""The sweep's share of its roofline, %: the least time (``leasttime.py``)
over the traced window's wall time a sweep."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not run["least_s"]:
        return None
    return 100.0 * run["least_s"] * tr["sweeps"] / tr["window_s"]
