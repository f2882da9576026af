"""setup.load_s: the seconds the process spent loading the port's CUDA
libraries (the nvcc build at a checkout's first run, and the dlopen),
read after the run from the port's own total, ``_build.load_seconds``:
set-up's, so not through the window's counters. A port without that
total reports nothing."""

import sys

BUILD = "accblas_tpu_torch.ops._build"


def read(ctx):
    return getattr(sys.modules.get(BUILD), "load_seconds", None)
