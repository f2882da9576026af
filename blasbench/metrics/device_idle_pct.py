"""device_idle_pct.<cell>: the share of the cell's profiled slices in which no
operation ran on the device."""

from blasbench.readers import idle_pct as read  # noqa: F401
