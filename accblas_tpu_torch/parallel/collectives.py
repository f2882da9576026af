"""The sharded layer's one contact with ``torch.distributed``.

Every process group, rendezvous and collective of ``accblas_tpu_torch.parallel``
goes through here:

- ``init`` / ``shutdown``: join or leave the default process group, through a
  ``FileStore`` (no TCP port is fixed) with a bounded timeout;
- ``new_groups``: the row and column groups of a rows x cols mesh, created
  by every rank in the same order;
- ``all_reduce_sum`` and ``all_gather`` over one mesh axis.

Each collective adds one to ``counts[(op, axis, dtype)]``, so a test can pin
the communication pattern of an op, as ``tests/test_parallel_structure.py``
pins the JAX package's jaxprs.

The transport is the backend of the process group, fixed when the mesh is
built. NCCL collects device tensors. Gloo collects host tensors, so a CUDA
tensor is staged through an explicit host copy and back (``Mesh.host_staged``):
NCCL refuses two ranks on one GPU, and several ranks sharing one card run
over gloo while their kernels still run on the card.
"""

from __future__ import annotations

import collections
import datetime
import os

import torch
import torch.distributed as dist

# collectives issued in this process, keyed by (op, axis, dtype name)
counts: collections.Counter = collections.Counter()

# seconds a rendezvous or a collective may wait for the other ranks
TIMEOUT_S = 60.0


def init(rank: int, world: int, store_dir: str, backend: str, timeout: float = TIMEOUT_S):
    """Join the default process group as `rank` of `world`, meeting the other
    ranks through a FileStore in `store_dir`."""
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))


def shutdown():
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank()


def world_size() -> int:
    return dist.get_world_size()


def backend() -> str:
    return dist.get_backend()


def new_groups(rows: int, cols: int) -> tuple[list, list]:
    """(row groups, column groups) of a rows x cols mesh laid out row-major
    over the ranks: row group r holds the ranks of mesh row r (a collective
    over the column axis), column group c those of mesh column c. Every rank
    must call this, in the same order as every other rank."""
    row_groups = [dist.new_group([r * cols + c for c in range(cols)]) for r in range(rows)]
    col_groups = [dist.new_group([r * cols + c for r in range(rows)]) for c in range(cols)]
    return row_groups, col_groups


def _count(op: str, axis: str, t: torch.Tensor):
    counts[(op, axis, str(t.dtype).removeprefix("torch."))] += 1


def all_reduce_sum(t: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """The sum of `t` over the ranks along mesh axis `axis`, as a new tensor
    of t's shape, dtype and device on every one of them."""
    _count("all_reduce", axis, t)
    buf = t.detach().reshape(-1).to("cpu" if mesh.host_staged else t.device, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return buf.to(t.device).reshape(t.shape)


def all_gather(t: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """The tensors `t` of the ranks along mesh axis `axis`, stacked in the
    order of their index on it: shape (extent,) + t.shape, on t's device."""
    _count("all_gather", axis, t)
    src = t.detach().contiguous()
    if mesh.host_staged:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, src, group=mesh.group(axis))
    return torch.stack(out).to(t.device)
