"""Milliseconds a sweep: the window's wall time over the sweeps in it."""


def read(run: dict):
    return 1e3 * run["window_s"] / len(run["sweep_s"])
