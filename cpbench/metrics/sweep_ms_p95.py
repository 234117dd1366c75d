"""The 95th percentile (nearest rank) of the window's sweep times, ms."""
import math


def read(run: dict):
    times = sorted(run["sweep_s"])
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
