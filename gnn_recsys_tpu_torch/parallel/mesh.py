"""Device meshes and batch placement.

Port of ``gnn_recsys_tpu/parallel/mesh.py``.  JAX drives every device of a
mesh from one process; so does the port.  A :class:`Mesh` is a grid of local
``torch.device`` entries with named axes, ``data`` (minibatch edges, users)
and ``model`` (catalog rows), as JAX's ``jax.sharding.Mesh``.  Work placed on
the mesh is launched on each entry's device from the one process, and what
``shard_map`` does with collectives is done with explicit copies onto the
mesh's first device (:mod:`gnn_recsys_tpu_torch.retrieval.sharded`).

An entry may repeat a device: a mesh of 8 CPU entries stands in for JAX's 8
virtual CPU devices in the tests, and a mesh of several entries on one card
runs every line of the sharded code but the copies between cards.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axes = Union[str, Sequence[str]]


class Mesh:
    """A grid of devices with named axes.

    ``devices``: an object array of ``torch.device`` whose shape is the
    mesh's; ``shape``: ordered ``{axis: extent}``, as JAX's ``mesh.shape``.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs {devices.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = collections.OrderedDict(zip(self.axis_names, devices.shape))

    @property
    def first_device(self) -> torch.device:
        """Where results come back (the entry at index 0 of every axis)."""
        return self.devices.flat[0]

    def axes(self, axis: Axes) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh axes are {self.axis_names}, not {unknown}")
        return axes

    def axes_size(self, axis: Axes) -> int:
        """Extent of one axis, or the product of several."""
        return int(np.prod([self.shape[a] for a in self.axes(axis)], dtype=np.int64))

    def shard_devices(self, axis: Axes) -> List[torch.device]:
        """The device of each shard of a dimension split over ``axis`` (one
        name or several, the first outermost, as JAX's ``axis_index`` counts
        them): the entry at index 0 of every other axis.  The entries along
        the other axes hold replicas in JAX; the port computes each shard
        once."""
        axes = self.axes(axis)
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        grid = self.devices.transpose(order + rest)
        grid = grid[(Ellipsis,) + (0,) * len(rest)] if rest else grid
        return list(grid.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``, so that entries compare equal
    to the devices tensors report."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    n_devices: Optional[int] = None,
    data_axis: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 2-d ('data', 'model') mesh over the first ``n_devices`` devices
    (``mesh.py:19-39``).  ``data_axis`` fixes the data extent; by default the
    model axis gets 2 when the count is even and above 1, else 1.

    ``devices``: the entries to take them from (``torch.device`` or
    strings, ``cuda`` meaning the current card; repeats allowed); by default
    the visible CUDA devices.  Asking for more devices than there are
    raises.
    """
    if devices is None:
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        where = "visible CUDA devices"
    else:
        pool = [_indexed(torch.device(d)) for d in devices]
        where = "devices given"
    n = n_devices or len(pool)
    if not 1 <= n <= len(pool):
        raise ValueError(f"a mesh of {n} devices, but there are {len(pool)} {where}")
    grid = np.empty(n, dtype=object)
    grid[:] = pool[:n]
    if len(axis_names) == 1:
        return Mesh(grid, tuple(axis_names))
    if data_axis is None:
        model = 2 if n % 2 == 0 and n > 1 else 1
        data_axis = n // model
    if n % data_axis:
        raise ValueError(f"data_axis={data_axis} does not divide {n} devices")
    return Mesh(grid.reshape(data_axis, n // data_axis), tuple(axis_names))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh: Mesh, tree) -> List:
    """``tree`` (tensors in dicts, lists, tuples) on every mesh entry: one
    tree an entry, in the grid's flat order.  Each distinct device gets one
    copy, which its entries share."""
    per_device = {d: _tree_map(lambda x, d=d: x.to(d), tree)
                  for d in dict.fromkeys(mesh.devices.flat)}
    return [per_device[d] for d in mesh.devices.flat]


def shard_batch(mesh: Mesh, tree, axis: Axes = "data") -> List:
    """The leading dimension of each tensor of ``tree`` split evenly over
    ``axis`` (``mesh.py:42-49``): one tree an entry, in the grid's flat
    order, holding the block at the entry's index along ``axis`` (entries
    along the other axes hold the same block)."""
    axes = mesh.axes(axis)
    m = mesh.axes_size(axes)
    coords = np.indices(mesh.devices.shape).reshape(len(mesh.axis_names), -1).T

    def block_of(coord) -> int:
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + int(coord[mesh.axis_names.index(a)])
        return idx

    def split(x):
        if x.shape[0] % m:
            raise ValueError(f"a leading dimension of {x.shape[0]} does not split over {m} shards")
        return x.reshape(m, x.shape[0] // m, *x.shape[1:])

    blocks = _tree_map(split, tree)
    return [_tree_map(lambda x, j=block_of(c), d=d: x[j].to(d), blocks)
            for c, d in zip(coords, mesh.devices.flat)]
