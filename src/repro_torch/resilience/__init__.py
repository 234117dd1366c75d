"""Numerical guards of the port (``numerics.guarded_solve``)."""
from . import numerics  # noqa: F401
