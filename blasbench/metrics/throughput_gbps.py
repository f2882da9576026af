"""throughput_gbps.<cell>: the op's bytes (``roofline.py``: for the DOT x and
y read and the scalar written; for the unit TRSV the strict upper triangle,
b and x) of every call in the window, over its seconds on the host clock."""

from blasbench.readers import throughput_gbps as read  # noqa: F401
