"""The yardstick's arithmetic: the card's peak bandwidth and the bytes an op
must move.

Bytes are those of the op, each input read once and each output written
once, whatever the kernel's tiling reads again: a unit triangular solve
reads the strict triangle, not whole diagonal tiles. Every op here does
O(1) operations a byte, so its bound is the bytes over the peak bandwidth.
The peaks are the data sheet's (H100 SXM5, 80 GB HBM3: 3.35 TB/s at the
700 W limit); a card set below that limit is reported beside the share.
"""

from __future__ import annotations

PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

ITEMSIZE = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1}


def peak_gbps(kind: str) -> float | None:
    """The data-sheet bandwidth of the card named `kind`, None if unknown."""
    for name in sorted(PEAK_GBPS, key=len, reverse=True):
        if kind.startswith(name):
            return PEAK_GBPS[name]
    return None


def dot_bytes(n: int, st_x: str, st_y: str) -> int:
    """x and y read once, the f32 result written once."""
    return n * (ITEMSIZE[st_x] + ITEMSIZE[st_y]) + 4


def gemv_bytes(m: int, n: int, st_a: str, st_x: str, st_out: str) -> int:
    """A and x read once, the result written once (beta = 0: res is not read)."""
    return m * n * ITEMSIZE[st_a] + n * ITEMSIZE[st_x] + m * ITEMSIZE[st_out]


def trsv_bytes(n: int, st_a: str, st_b: str, st_x: str, unit: bool) -> int:
    """The strict triangle (and the diagonal unless unit) read once, b read
    once, x written once."""
    tri = n * (n - 1) // 2 + (0 if unit else n)
    return tri * ITEMSIZE[st_a] + n * (ITEMSIZE[st_b] + ITEMSIZE[st_x])


def bound_ms(nbytes: int, gbps: float) -> float:
    """The least time `nbytes` take at `gbps`."""
    return nbytes / (gbps * 1e6)
