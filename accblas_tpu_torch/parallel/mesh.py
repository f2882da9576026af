"""The 2-D mesh of ranks and the blocks each rank holds.

A ``Mesh`` is the port's ``jax.sharding.Mesh``: rows x cols ranks of the
default process group, laid out row-major (rank r sits at (r // cols,
r % cols)), with one process group per mesh row and per mesh column, this
rank's device and the transport. Where the JAX package hands a global array
to ``shard_map``, a rank here holds its own block: ``shard`` cuts it from
the global array, padded as the JAX package pads uneven shapes, and
``unshard`` gathers the blocks back into the global array on every rank.

A spec names, for each dimension, the mesh axis it is split over or None
(replicated), as a ``PartitionSpec`` does: ``("rows", "cols")`` for a
matrix sharded both ways, ``("cols",)`` for a vector over the columns,
``(None, "cols")`` for the right-hand sides of a TRSM.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..accessor import dtypes
from ..utils import interop
from . import collectives


@dataclasses.dataclass(frozen=True)
class Mesh:
    """rows x cols ranks; this rank at (row, col) on `device`."""

    axis_names: tuple[str, str]
    rows: int
    cols: int
    row: int
    col: int
    device: torch.device
    transport: str  # the process group's backend: "nccl" or "gloo"
    groups: dict  # axis name -> the process group of this rank along it

    @property
    def shape(self) -> dict:
        """{axis name: extent}, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: self.rows, self.axis_names[1]: self.cols}

    @property
    def host_staged(self) -> bool:
        """Collectives copy CUDA tensors through the host (gloo on a card)."""
        return self.transport == "gloo" and self.device.type == "cuda"

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (``jax.lax.axis_index``)."""
        return self.row if axis == self.axis_names[0] else self.col

    def group(self, axis: str):
        return self.groups[axis]


def _factor(n: int) -> tuple[int, int]:
    """rows x cols = n, as square as n allows, rows <= cols (8 -> 2x4)."""
    rows = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            rows = cand
            break
    return rows, n // rows


def make_mesh(n_devices: int | None = None, axes=("rows", "cols"),
              shape: tuple[int, int] | None = None, *, device=None) -> Mesh:
    """A rows x cols mesh over all ranks of the process group, as square as
    the world size allows (8 -> 2x4), or of the explicit ``shape=(rows,
    cols)``. `n_devices`, if given, must be the world size.

    `device`: None puts this rank on ``cuda:(rank % device_count)`` and
    raises where there is no card; ``"cpu"`` (or any torch device) is
    taken as given. Every rank must call this, in the same order, since it
    creates the mesh's process groups."""
    world, rank = collectives.world_size(), collectives.rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has {world} ranks")
    if shape is None:
        rows, cols = _factor(world)
    else:
        rows, cols = shape
        if rows * cols != world:
            raise ValueError(f"mesh shape {shape} != {world} devices")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (torch.cuda.is_available() is "
                               "False); pass device='cpu' to run the ranks on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    transport = collectives.backend()
    if transport == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: an nccl process group cannot carry {device} tensors")
    row_groups, col_groups = collectives.new_groups(rows, cols)
    row, col = divmod(rank, cols)
    mesh = Mesh(tuple(axes), rows, cols, row, col, device, transport,
                {axes[1]: row_groups[row], axes[0]: col_groups[col]})
    if mesh.host_staged and rank == 0:
        print(f"transport: gloo, host-staged (mesh {rows}x{cols} on {device.type})",
              file=sys.stderr, flush=True)
    return mesh


def _block_bounds(size: int, ext: int, idx: int) -> tuple[int, int, int]:
    """(start, stop, block length) of block `idx` of `size` split into `ext`
    blocks after zero-padding to a multiple of `ext`; stop <= size."""
    blk = -(-size // ext)
    start = min(idx * blk, size)
    return start, min(start + blk, size), blk


def shard(arr, mesh: Mesh, spec, *, identity_tail: bool = False, st=None) -> torch.Tensor:
    """This rank's block of the global array `arr` (numpy, carried bit for
    bit by ``interop.from_numpy``, or a tensor), on the mesh's device.

    Each dimension split over an axis is zero-padded to a multiple of the
    axis' extent (as the JAX package's ``_pad_to``: zeros add nothing to
    any contraction, so the padded lanes are exact no-ops). With
    `identity_tail` (the square triangle of ``ptrsv``), both dimensions are
    padded to that multiple of the first split axis' extent, with ones on
    the padded diagonal, so the padded unknowns solve to exact zeros. `st`
    casts the block to that storage type (round to nearest even)."""
    spec = tuple(spec) + (None,) * (arr.ndim - len(spec))
    sizes = list(arr.shape)
    if identity_tail:
        if arr.ndim != 2 or sizes[0] != sizes[1]:
            raise ValueError(f"identity_tail needs a square matrix, got {tuple(arr.shape)}")
        ext = mesh.shape[next(a for a in spec if a is not None)]
        sizes = [-(-sizes[0] // ext) * ext] * 2
    index, blocks = [], []
    for d, axis in enumerate(spec):
        if axis is None:
            index.append(slice(0, arr.shape[d]))
            blocks.append((0, sizes[d]))
            continue
        start, stop, blk = _block_bounds(sizes[d], mesh.shape[axis], mesh.index(axis))
        index.append(slice(min(start, arr.shape[d]), min(stop, arr.shape[d])))
        blocks.append((start, blk))
    part = arr[tuple(index)]
    if isinstance(arr, np.ndarray):
        part = interop.from_numpy(np.asarray(part), device=mesh.device).reshape(np.shape(part))
    else:
        part = part.to(mesh.device)
    out = part.new_zeros(tuple(b for _, b in blocks))
    out[tuple(slice(0, s) for s in part.shape)] = part
    if identity_tail:
        n = arr.shape[0]
        (r0, rb), (c0, _) = blocks
        rows = torch.arange(max(r0, n), max(r0 + rb, n), device=out.device)
        out[rows - r0, rows - c0] = 1
    return out if st is None else out.to(dtypes.torch_dtype(st))


def unshard(block: torch.Tensor, mesh: Mesh, spec, shape) -> torch.Tensor:
    """The global array of `shape` from every rank's `block` (the inverse of
    ``shard``), on every rank: the blocks are gathered along each split
    dimension and the padding is cut away."""
    spec = tuple(spec) + (None,) * (block.dim() - len(spec))
    out = block
    for d, axis in enumerate(spec):
        if axis is not None:
            out = torch.cat(collectives.all_gather(out, axis, mesh).unbind(0), d)
    return out[tuple(slice(0, s) for s in shape)]
