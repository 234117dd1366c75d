"""Peak device memory allocated over the program's set-up and the window,
GB (1e9 bytes)."""


def read(run: dict):
    return run["peak_bytes"] / 1e9 if run["peak_bytes"] else None
