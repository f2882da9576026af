"""dot_roofline: the DOT's bytes at 3.35 TB/s over the device time of
everything ``acc_dot`` launched, a call on average."""

from blasbench.readers import call_roofline_pct as read  # noqa: F401
