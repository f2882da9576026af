"""Sharded BLAS over a mesh of ranks on ``torch.distributed`` (counterpart
of ``accblas_tpu.parallel``): each rank holds its blocks (``shard``), the
ops combine them with counted collectives (``collectives``), and ``launch``
runs a function on R ranks."""

from .blas import pcg, pdot, pgemv, power_step, ptrsm, ptrsv
from .mesh import Mesh, make_mesh, shard, unshard

__all__ = ["pcg", "pdot", "pgemv", "power_step", "ptrsm", "ptrsv", "make_mesh", "Mesh", "shard",
           "unshard"]
