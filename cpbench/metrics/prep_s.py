"""Host preprocessing seconds: ``build_flycoo``, ``prepare_runtime`` and
``cpals.device_state``."""


def read(run: dict):
    return run["prep_s"]
