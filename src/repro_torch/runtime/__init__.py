"""Device policy of the port (``device.resolve_device``) and the
fault-tolerant loop runner (``fault_tolerance``)."""
from . import device  # noqa: F401
