"""Run a function on R ranks, one process each, joined in one process group.

    results = launch.run(fn, 4, *args, device="cpu")   # or device=None: the cards

`fn` must be importable by name (a module-level function of this package,
or of the script that was run), since each rank is a spawned process that
starts from a fresh import: it imports this package and torch, never the
caller's test module. The ranks meet through a ``FileStore`` in a temporary
directory, so no TCP port is fixed and several launches may run at once.
Each rank calls ``fn(*args)`` and its result comes back, pickled, in rank
order. If a rank raises, dies or runs past the deadline, the other ranks
are stopped and ``run`` raises with that rank's traceback.

The backend: gloo on the CPU; on a card NCCL when every rank has a card of
its own, else gloo with host-staged collectives (NCCL refuses two ranks on
one GPU). On a card the parent builds the CUDA libraries before the spawn,
so the ranks do not each run nvcc.

`apply` is a rank program for callers that cannot send functions, such as
the tests: it runs a list of `Call`s of this package's functions on blocks
cut from global numpy arrays and returns their gathered results.
"""

from __future__ import annotations

import collections
import importlib
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

from . import collectives

# seconds a launch may take from the spawn to the last rank's result
DEADLINE_S = 600.0


def _rank_main(rank: int, world: int, store_dir: str, backend: str, device_type: str, results):
    """The spawned process of one rank: join the group, run the function the
    parent left in `store_dir`, report."""
    if device_type == "cpu":
        torch.set_num_threads(1)  # R ranks share the host's cores
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        with open(os.path.join(store_dir, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)  # written by run() in the parent
        collectives.init(rank, world, store_dir, backend)
        try:
            out = fn(*args)
        finally:
            collectives.shutdown()
    except Exception:  # noqa: BLE001 - the rank's failure goes to the parent, whole
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))


def _collect(procs, results, n_ranks: int, deadline: float) -> dict:
    got = {}
    while len(got) < n_ranks:
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(n_ranks)) - set(got))
            raise RuntimeError(f"launch: ranks {missing} gave no result within the deadline")
        try:
            rank, ok, value = results.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"launch: rank {dead[0]} died with exit code "
                                   f"{procs[dead[0]].exitcode} and no result") from None
            continue
        if not ok:
            raise RuntimeError(f"launch: rank {rank} of {n_ranks} raised:\n{value}")
        got[rank] = value
    return got


def run(fn, n_ranks: int, *args, device=None, timeout: float = DEADLINE_S) -> list:
    """fn(*args) on `n_ranks` spawned ranks; their results in rank order.
    `device` says where the ranks compute ("cuda", or None for the cards,
    which raises where there is none; "cpu" only when asked), which sets
    the backend; the ranks choose their own device (``make_mesh``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: no CUDA device (torch.cuda.is_available() is False)")
        from ..ops import _build

        _build.build()
        backend = "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    else:
        backend = "gloo"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="accblas_launch_") as store_dir:
        # the function and its arguments go through a file: a large argument
        # written down the spawn pipe would block the parent until the
        # child reads it, however the child fares
        with open(os.path.join(store_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_ranks, store_dir, backend, device.type, results))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        ok = False
        try:
            got = _collect(procs, results, n_ranks, time.monotonic() + timeout)
            ok = True
        finally:
            for p in procs:
                p.join(30 if ok else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
            results.close()
    return [got[r] for r in range(n_ranks)]


# --------------------------------------------------------------------------
# apply: a list of calls, for callers that cannot send functions
# --------------------------------------------------------------------------

class Sharded(NamedTuple):
    """An argument of a `Call`: the global numpy `array`, of which each rank
    gets its block, ``mesh.shard(array, mesh, spec, identity_tail=...,
    st=...)`` (a plain numpy argument goes whole to every rank)."""

    array: np.ndarray
    spec: tuple
    identity_tail: bool = False
    st: str | None = None


class Call(NamedTuple):
    """One call of `apply`: ``fn(*args, mesh=mesh, **kwargs)`` on the mesh of
    `shape` and `axes`. `fn` names a function of this package as
    "module:name". `out` holds, for each output, None (the same on every
    rank) or (spec, global shape) to gather it with ``unshard``."""

    fn: str
    args: tuple = ()
    kwargs: dict | None = None
    out: tuple = (None,)
    shape: tuple | None = None
    axes: tuple = ("rows", "cols")


def _resolve(name: str):
    mod, _, attr = name.partition(":")
    if not mod.startswith("accblas_tpu_torch."):
        raise ValueError(f"apply: {name!r} is not a function of accblas_tpu_torch")
    return getattr(importlib.import_module(mod), attr)


def _as_f64(v) -> np.ndarray:
    from ..ops import df64 as dfm

    if isinstance(v, dfm.DF):
        v = dfm.df_to_f64(v)
    return torch.as_tensor(v).double().cpu().numpy()


def apply(calls, device=None) -> list[dict]:
    """Run `calls` in order on this rank, on `device` (None: this rank's
    card, as ``make_mesh`` picks it). Each result is a dict: `values`,
    the outputs as float64 numpy arrays (a DF as hi + lo, exactly),
    `dtypes`, their torch dtypes, and `counts`, the collectives the call
    itself issued, {(op, axis, dtype): n}."""
    from ..ops import df64 as dfm
    from .mesh import make_mesh, shard, unshard

    meshes, out = {}, []
    for c in calls:
        key = (c.shape, tuple(c.axes))
        if key not in meshes:
            meshes[key] = make_mesh(None, c.axes, c.shape, device=device)
        mesh = meshes[key]

        def arg(a, mesh=mesh):
            if isinstance(a, Sharded):
                return shard(a.array, mesh, a.spec, identity_tail=a.identity_tail, st=a.st)
            if isinstance(a, np.ndarray):  # replicated: the whole array on every rank
                return shard(a, mesh, ())
            return a

        args = [arg(a) for a in c.args]
        kwargs = {k: arg(v) for k, v in (c.kwargs or {}).items()}
        before = collections.Counter(collectives.counts)
        res = _resolve(c.fn)(*args, mesh=mesh, **kwargs)
        counts = dict(collectives.counts - before)
        res = (res,) if isinstance(res, dfm.DF) or not isinstance(res, tuple) else res
        values, kinds = [], []
        for v, spec in zip(res, c.out):
            if spec is not None:
                v = unshard(v, mesh, *spec)
            kinds.append(str((v.hi if isinstance(v, dfm.DF) else torch.as_tensor(v)).dtype))
            values.append(_as_f64(v))
        out.append({"values": values, "dtypes": kinds, "counts": counts})
    return out
