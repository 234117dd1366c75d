"""Set-up seconds: process start to the window's start (host clock)."""


def read(run: dict):
    return run["setup_s"]
