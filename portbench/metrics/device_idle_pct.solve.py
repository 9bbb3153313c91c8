"""Share of the traced slice in which the device ran nothing, %."""

from portbench.readers import idle_pct as read  # noqa: F401
