"""Processes that train one model together.

Port of ``gnn_recsys_tpu/parallel/distributed.py``.  Inside a process one
Python thread drives every local device of a mesh (``parallel/mesh.py``);
processes join through ``torch.distributed``: NCCL where every process owns
its own cards, gloo on the CPU (and where two processes share a card: NCCL
refuses two ranks on one GPU).  A :class:`GlobalMesh` is this process's
grid of local devices with the data axis continued over the processes:
process ``r`` holds global data shards ``[r * d, (r + 1) * d)``.  A
reduction over such an axis sums onto the process's first device, then
``all_reduce``s across processes.  The ``model`` axis stays inside a
process (asking for one across processes raises).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gnn_recsys_tpu_torch.parallel.mesh import Mesh, _tree_map, make_mesh, replicate, shard_batch


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = 300.0) -> None:
    """Join this process to the others (``distributed.py:20-49``).

    With no arguments: best effort, from ``torchrun``'s environment
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) where it is set, else
    nothing (one process).  With an explicit coordinator (``host:port``,
    reached as ``tcp://host:port``) or process count, a failure raises: two
    processes that did not join would train two models.  A second call is
    a no-op.  ``backend``: by default NCCL where CUDA is available, else
    gloo."""
    if dist.is_available() and dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if not explicit:
        if all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            try:
                dist.init_process_group(backend, timeout=timeout)
            except (RuntimeError, ValueError):
                pass
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("an explicit start needs coordinator_address, num_processes and "
                         "process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout)


class GlobalMesh(Mesh):
    """This process's devices, a ('data', 'model') grid whose data axis
    continues over ``processes`` processes; ``process_index`` is this
    one's.  ``shape`` is the local grid's."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], processes: int,
                 process_index: int, backend: str):
        super().__init__(devices, axis_names)
        self.processes, self.process_index, self.backend = processes, process_index, backend

    def __repr__(self) -> str:
        return (f"GlobalMesh(process {self.process_index} of {self.processes}, "
                f"{dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})")


def global_mesh(axis_names=("data", "model"), data_axis: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over every process's devices (``distributed.py:52-57``; call
    after :func:`initialize_multihost`).  ``devices``: this process's
    entries (by default its visible cards); every process must give as
    many.  ``data_axis``: the global data extent; by default every entry is
    a data shard but for a model axis of 2 where the local count is even, as
    :func:`~gnn_recsys_tpu_torch.parallel.mesh.make_mesh`.  Without a
    process group, the local mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(data_axis=data_axis, axis_names=axis_names, devices=devices)
    procs, rank = dist.get_world_size(), dist.get_rank()
    local = make_mesh(axis_names=axis_names, devices=devices)
    n = local.devices.size
    if len(axis_names) > 1:
        if data_axis is None:
            data_local = local.shape[axis_names[0]]
        else:
            if data_axis % procs:
                raise ValueError(f"a data axis of {data_axis} does not split over {procs} "
                                 "processes")
            data_local = data_axis // procs
        if n % data_local:
            raise ValueError(f"the model axis stays inside a process: {n} local devices do not "
                             f"hold {data_local} data shards of a whole model axis")
        local = make_mesh(n, data_axis=data_local, axis_names=axis_names, devices=devices)
    return GlobalMesh(local.devices, local.axis_names, procs, rank, dist.get_backend())


def extent(mesh: Mesh, axis: str) -> int:
    """Global extent of ``axis`` (the data axis spans the processes)."""
    return mesh.shape[axis] * _spanning(mesh, axis)


def first_shard(mesh: Mesh, axis: str) -> int:
    """Global index of this process's first shard of ``axis``."""
    return mesh.shape[axis] * getattr(mesh, "process_index", 0) if _spanning(mesh, axis) > 1 else 0


def _spanning(mesh: Mesh, axis: str) -> int:
    return getattr(mesh, "processes", 1) if axis == mesh.axis_names[0] else 1


def all_reduce_sum(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` (on one device) summed over the processes of ``mesh``:
    one flat ``all_reduce`` (through the host on gloo); as they are in one
    process."""
    if getattr(mesh, "processes", 1) == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dev = flat.device
    if mesh.backend == "gloo" and dev.type == "cuda":
        flat = flat.cpu()
    dist.all_reduce(flat)
    flat = flat.to(dev)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape).to(t.dtype))
        o += t.numel()
    return out


def global_put(mesh: Mesh, tree, spec: Optional[str] = None) -> List:
    """Per-process-identical host values on this process's entries
    (``distributed.py:60-80``): replicated by default; with ``spec`` an axis
    name, the leading dimension split over the axis's global extent, each
    process keeping only its own shards' blocks.  One value an entry, in the
    local grid's flat order."""
    if spec is None:
        return replicate(mesh, tree)
    procs = _spanning(mesh, spec)
    if procs == 1:
        return shard_batch(mesh, tree, spec)
    first = first_shard(mesh, spec)
    d = mesh.shape[spec]

    def mine(x):
        if x.shape[0] % (d * procs):
            raise ValueError(f"a leading dimension of {x.shape[0]} does not split over "
                             f"{d * procs} shards")
        n = x.shape[0] // (d * procs)
        return x[first * n:(first + d) * n]

    return shard_batch(mesh, _tree_map(mine, tree), spec)
