"""Run directories (parameters, model config, graph, id maps) and the train
state for resuming.

Port of ``save_run`` / ``load_run`` (``gnn_recsys_tpu/train/checkpoint.py:88-153``)
in the JAX package's formats — ``model.json``, ``fixed_params.json``,
``hyper_params.json``, ``graph.npz`` and the optional ``id_maps.pkl`` /
``extras.pkl`` — except the parameters: the JAX package writes them with
orbax (``params/``), which the port cannot read; the port writes
``params.npz``, keyed by flax path (``params/layer0_user__buys__item/
fc_self/kernel``) in flax's layout.  ``save_train_state`` /
``load_train_state`` (``checkpoint.py:42-86``) write the port's own format
(one ``torch.save`` file), not orbax's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from gnn_recsys_tpu_torch.graph.hetero import HeteroGraph
from gnn_recsys_tpu_torch.graph.serialize import load_graph, save_graph
from gnn_recsys_tpu_torch.models.convert import params_from_jax, params_to_jax
from gnn_recsys_tpu_torch.train.full_batch import TrainState

PARAMS_FILE = "params.npz"


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, Mapping) else {path: v})
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_params(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a model's state_dict as flax-path-keyed arrays (.npz)."""
    with open(path, "wb") as f:
        np.savez(f, **_flatten(params_to_jax(state_dict)))


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read :func:`save_params`' file back as a state_dict."""
    with np.load(path) as z:
        return params_from_jax(_unflatten({k: z[k] for k in z.files}))


def save_train_state(state: TrainState, path: str) -> None:
    """Save a :class:`TrainState` for an exact resume: the model's
    parameters, the optimizer's state (Adam's moments and counts), the
    learning-rate schedule's state and the number of updates, as one
    ``torch.save`` file of state dicts (the port's own format; the JAX
    package writes orbax).  Resume with :func:`load_train_state` and
    ``train_minibatch(..., state=restored, start_epoch=E)``."""
    torch.save({"params": state.model.state_dict(), "opt_state": state.tx.state_dict(),
                "schedule": None if state.schedule is None else state.schedule.state_dict(),
                "step": state.step}, path)


def load_train_state(path: str, like: TrainState) -> TrainState:
    """Restore a state saved by :func:`save_train_state` into ``like``, a
    freshly created :class:`TrainState` of the same model and optimizer (and
    schedule), whose objects it updates in place; returns ``like``."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if (saved["schedule"] is None) != (like.schedule is None):
        raise ValueError("the saved state and `like` differ in having a learning-rate schedule")
    like.model.load_state_dict(saved["params"])
    like.tx.load_state_dict(saved["opt_state"])
    if like.schedule is not None:
        like.schedule.load_state_dict(saved["schedule"])
    like.step = int(saved["step"])
    return like


def save_run(
    out_dir: str,
    state_dict: Mapping[str, torch.Tensor],
    model_kwargs: Dict[str, Any],
    fixed_params=None,
    hyper_params=None,
    graph: Optional[HeteroGraph] = None,
    id_maps: Optional[Dict[str, Any]] = None,
    extras: Optional[Dict[str, Any]] = None,
) -> None:
    """Persist everything inference needs (reference main_train.py:384-406)."""
    os.makedirs(out_dir, exist_ok=True)
    save_params(state_dict, os.path.join(out_dir, PARAMS_FILE))
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(model_kwargs, f, indent=2, default=str)
    for name, cfg in (("fixed_params", fixed_params), ("hyper_params", hyper_params)):
        if cfg is not None:
            with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2)
    if graph is not None:
        save_graph(graph, os.path.join(out_dir, "graph.npz"))
    for name, obj in (("id_maps", id_maps), ("extras", extras or None)):
        if obj is not None:
            with open(os.path.join(out_dir, f"{name}.pkl"), "wb") as f:
                pickle.dump(obj, f)


def load_run(out_dir: str) -> Dict[str, Any]:
    """Load a run directory saved by :func:`save_run`.

    Returns a dict with keys params (a state_dict), model_kwargs,
    fixed_params, hyper_params, graph, id_maps, extras (None when absent).
    Unpickling id maps needs pandas, which is imported only then.
    """
    ppath = os.path.join(out_dir, PARAMS_FILE)
    if not os.path.exists(ppath):
        if os.path.isdir(os.path.join(out_dir, "params")):
            raise ValueError(
                f"{out_dir} holds orbax parameters (params/), which the PyTorch "
                f"port cannot read; re-save the run with {PARAMS_FILE}"
            )
        raise FileNotFoundError(ppath)
    out: Dict[str, Any] = {"params": load_params(ppath)}
    with open(os.path.join(out_dir, "model.json")) as f:
        out["model_kwargs"] = json.load(f)
    for name in ("fixed_params", "hyper_params"):
        p = os.path.join(out_dir, f"{name}.json")
        out[name] = None
        if os.path.exists(p):
            with open(p) as f:
                out[name] = json.load(f)
    gpath = os.path.join(out_dir, "graph.npz")
    out["graph"] = load_graph(gpath) if os.path.exists(gpath) else None
    for name in ("id_maps", "extras"):
        p = os.path.join(out_dir, f"{name}.pkl")
        out[name] = None
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[name] = pickle.load(f)
    return out


def model_kwargs_to_config(model_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """JSON round-trip fixups: tuples come back as lists."""
    kw = dict(model_kwargs)
    if "canonical_etypes" in kw:
        kw["canonical_etypes"] = tuple(tuple(e) for e in kw["canonical_etypes"])
    if "dims" in kw:
        kw["dims"] = tuple((str(k), int(v)) for k, v in kw["dims"])
    return kw
