"""Carry weights between the JAX package's flax tree and the port's model.

flax variables look like ``{"params": {"user_embed": {"proj_feats":
{"kernel": [in, out], "bias": [out]}}, "layer0_user__buys__item":
{"fc_self": {"kernel": ...}, ...}}}``; the port's state_dict keys are the
same path with dots and ``weight``/``bias`` leaves, a Dense ``kernel``
``[in, out]`` becoming a Linear ``weight`` ``[out, in]``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LEAF_TO_TORCH = {"kernel": "weight", "bias": "bias"}
_LEAF_TO_FLAX = {v: k for k, v in _LEAF_TO_TORCH.items()}


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of arrays, with or without the
    ``"params"`` level) -> the port's ``state_dict`` (f32 CPU tensors)."""
    params = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    for mod_name, sub in params.items():
        for lin_name, leaves in sub.items():
            for leaf, arr in leaves.items():
                if leaf not in _LEAF_TO_TORCH:
                    raise KeyError(f"unexpected flax leaf {mod_name}/{lin_name}/{leaf}")
                t = torch.from_numpy(np.array(arr, dtype=np.float32))
                if leaf == "kernel":
                    t = t.T.contiguous()
                out[f"{mod_name}.{lin_name}.{_LEAF_TO_TORCH[leaf]}"] = t
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`params_from_jax`: ``{"params": {...}}`` of numpy
    arrays in flax's layout."""
    params: Dict = {}
    for key, t in state_dict.items():
        mod_name, lin_name, leaf = key.split(".")
        arr = t.detach().cpu().float().numpy()
        if leaf == "weight":
            arr = np.ascontiguousarray(arr.T)
        params.setdefault(mod_name, {}).setdefault(lin_name, {})[_LEAF_TO_FLAX[leaf]] = arr
    return {"params": params}
