"""Device policy of the port (``device.resolve_device``)."""
from . import device  # noqa: F401
