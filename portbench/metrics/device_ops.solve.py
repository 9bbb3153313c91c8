"""Device operations one request ran in the traced slice (a lower bound)."""

from portbench.readers import device_ops as read  # noqa: F401
