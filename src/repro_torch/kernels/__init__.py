"""Hand-written GPU kernels of the port (built lazily at first launch)."""
