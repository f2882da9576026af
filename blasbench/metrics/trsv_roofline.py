"""trsv_roofline: the unit solve's bytes (the strict upper triangle, b and x)
at 3.35 TB/s over the device time of everything ``trsv`` launched (the leaf
gather and inverses, the right-hand side panel, the sweep), a call on
average."""

from blasbench.readers import call_roofline_pct as read  # noqa: F401
