"""Share of the traced window in which no device operation runs, %."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
