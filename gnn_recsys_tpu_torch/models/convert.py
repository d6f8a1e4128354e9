"""Carry weights between the JAX package's flax tree and the port's model.

flax variables look like ``{"params": {"user_embed": {"proj_feats":
{"kernel": [in, out], "bias": [out]}}, "layer0_user__buys__item":
{"fc_self": {"kernel": ...}, ...}}}``; the port's state_dict keys are the
same path with dots and ``weight``/``bias`` leaves, a Dense ``kernel``
``[in, out]`` becoming a Linear ``weight`` ``[out, in]``.

The LSTM aggregator's cell is the exception: flax keeps eight Denses,
``<layer>/lstm/scan/cell/{ii,if,ig,io}`` (input, no bias) and
``{hi,hf,hg,ho}`` (recurrent, with bias), each ``[in, H]``; the port packs
each kind into one Linear in gate order i, f, g, o
(:class:`~gnn_recsys_tpu_torch.models.layers.MaskedLSTMReducer`):
``<layer>.lstm.ih.weight`` ``[4H, in]`` and ``<layer>.lstm.hh.weight`` /
``.bias`` ``[4H, H]`` / ``[4H]``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LEAF_TO_TORCH = {"kernel": "weight", "bias": "bias"}
_LEAF_TO_FLAX = {v: k for k, v in _LEAF_TO_TORCH.items()}
_GATES = ("i", "f", "g", "o")  # the packed order
_CELL = ("scan", "cell")  # flax's path from the reducer to its Denses
_PACKED = {"i": "ih", "h": "hh"}  # flax's Dense prefix -> the port's Linear
_UNPACKED = {v: k for k, v in _PACKED.items()}


def _paths(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of arrays, with or without the
    ``"params"`` level) -> the port's ``state_dict`` (f32 CPU tensors)."""
    params = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    gates: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, arr in _paths(params):
        *mods, lin, leaf = path
        if leaf not in _LEAF_TO_TORCH:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":
            t = t.T.contiguous()
        if tuple(mods[-2:]) == _CELL:  # one gate of an LSTM cell
            key = ".".join([*mods[:-2], _PACKED[lin[0]], _LEAF_TO_TORCH[leaf]])
            gates.setdefault(key, {})[lin[1]] = t
        else:
            out[".".join([*mods, lin, _LEAF_TO_TORCH[leaf]])] = t
    for key, parts in gates.items():
        out[key] = torch.cat([parts[g] for g in _GATES])
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`params_from_jax`: ``{"params": {...}}`` of numpy
    arrays in flax's layout."""
    params: Dict = {}
    for key, t in state_dict.items():
        *mods, lin, leaf = key.split(".")
        arr = t.detach().cpu().float().numpy()
        if lin in _UNPACKED:  # an LSTM cell's packed gates
            pieces = [([*mods, *_CELL, _UNPACKED[lin] + g], part)
                      for g, part in zip(_GATES, np.split(arr, 4))]
        else:
            pieces = [([*mods, lin], arr)]
        for path, a in pieces:
            if leaf == "weight":
                a = np.ascontiguousarray(a.T)
            node = params
            for name in path:
                node = node.setdefault(name, {})
            node[_LEAF_TO_FLAX[leaf]] = a
    return {"params": params}
