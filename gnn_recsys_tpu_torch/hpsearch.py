"""The hyperparameter search.

Port of ``gnn_recsys_tpu/hpsearch.py`` (reference ``main.py:450-607``): the
reference's 14-dimension space (``SearchableHyperparameters``,
``main.py:485-511``), the defaults asked first (skopt's ``x0``), a JSON
checkpoint after every trial with resume from the latest one, and
``random_state=46``.  ``optimizer='gp'`` is the GP-EI loop of
:mod:`gnn_recsys_tpu_torch.gp_opt` (the reference's ``gp_minimize(
acq_func='EI')``); ``'random'`` asks the defaults, then uniform draws and
perturbations of the incumbent.

Checkpoints are the JAX package's format: either package resumes the
other's.  A legacy ``.pkl`` checkpoint holds the JAX package's classes, so
the port refuses it.  A resumed GP search rebuilds its optimizer from a
fresh generator and replays the finished trials into it, as the JAX package
does, so its first random ask repeats the run's first random point
(ROADMAP.md, queue 3); the port follows it, so that both packages propose
the same trials.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from gnn_recsys_tpu_torch.config import HyperParams
from gnn_recsys_tpu_torch.gp_opt import GPOptimizer, Space
from gnn_recsys_tpu_torch.utils.logging import get_logger

# The 14-dim space, reference main.py:485-507.
SEARCH_SPACE: Dict[str, Tuple] = {
    "aggregator_hetero": ("cat", ["mean", "sum", "max"]),
    "aggregator_type": ("cat", ["mean", "mean_nn", "pool_nn"]),
    "clicks_sample": ("float", 0.2, 1.0, False),
    "delta": ("float", 0.15, 0.35, False),
    "dropout": ("float", 0.0, 0.8, False),
    "embedding_layer": ("cat", [True, False]),
    "embed_dim": ("cat", ["small", "medium", "large"]),
    "lr": ("float", 1e-4, 1e-2, True),
    "n_layers": ("int", 3, 5),
    "neg_sample_size": ("int", 700, 3000),
    "norm": ("cat", [True, False]),
    "popularity_importance": ("cat", ["no", "small", "medium", "large"]),
    "purchases_sample": ("float", 0.5, 1.0, False),
    "use_recency": ("cat", [True, False]),
}


def sample_hyperparams(rng: np.random.Generator) -> HyperParams:
    """Uniform draw from the search space."""
    kwargs = {}
    for name, spec in SEARCH_SPACE.items():
        kind = spec[0]
        if kind == "cat":
            kwargs[name] = spec[1][rng.integers(0, len(spec[1]))]
        elif kind == "float":
            lo, hi, log = spec[1], spec[2], spec[3]
            if log:
                kwargs[name] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            else:
                kwargs[name] = float(rng.uniform(lo, hi))
        elif kind == "int":
            kwargs[name] = int(rng.integers(spec[1], spec[2] + 1))
    return HyperParams(**kwargs)


def perturb_hyperparams(
    base: HyperParams, rng: np.random.Generator, n_dims: int = 3
) -> HyperParams:
    """Resample a few dimensions of the incumbent (local exploitation)."""
    kwargs = dataclasses.asdict(base)
    names = list(SEARCH_SPACE.keys())
    fresh = dataclasses.asdict(sample_hyperparams(rng))
    for name in rng.choice(names, size=min(n_dims, len(names)), replace=False):
        kwargs[name] = fresh[name]
    return HyperParams(**kwargs)


@dataclasses.dataclass
class Trial:
    hyper: HyperParams
    objective: float  # NEGATIVE recall (minimized, skopt convention)


@dataclasses.dataclass
class SearchState:
    trials: List[Trial]
    seed: int = 46

    @property
    def best(self) -> Optional[Trial]:
        if not self.trials:
            return None
        return min(self.trials, key=lambda t: t.objective)


def _checkpoint_name() -> str:
    return "checkpoint" + datetime.datetime.now().strftime("%Y%m%d_%H%M%S") + ".json"


def latest_checkpoint(logdir: str = ".") -> Optional[str]:
    files = sorted(
        (f for f in os.listdir(logdir) if f.startswith("checkpoint")
         and (f.endswith(".json") or f.endswith(".pkl"))),
        key=lambda f: os.path.splitext(f)[0],
    )
    return os.path.join(logdir, files[-1]) if files else None


def load_checkpoint(path: str) -> SearchState:
    """A search checkpoint in JSON (either package's).  A ``.pkl`` checkpoint
    would unpickle the JAX package's classes, so it is refused."""
    if not path.endswith(".json"):
        raise ValueError(
            f"{path}: only JSON search checkpoints are read; a .pkl checkpoint unpickles "
            "the JAX package's classes (resume it with the JAX package, which writes JSON)")
    with open(path) as f:
        d = json.load(f)
    return SearchState(
        trials=[Trial(hyper=HyperParams(**t["hyper"]), objective=float(t["objective"]))
                for t in d["trials"]],
        seed=int(d.get("seed", 46)),
    )


def save_checkpoint(state: SearchState, path: str) -> None:
    with open(path, "w") as f:
        json.dump(
            {
                "seed": state.seed,
                "trials": [
                    {"hyper": dataclasses.asdict(t.hyper), "objective": t.objective}
                    for t in state.trials
                ],
            },
            f,
        )


def run_search(
    fitness: Callable[[HyperParams], float],
    n_calls: int = 200,
    logdir: str = ".",
    from_beginning: bool = False,
    seed: int = 46,
    exploit_prob: float = 0.3,
    optimizer: str = "gp",
    verbose: bool = False,
) -> SearchState:
    """Minimize ``-recall`` over ``n_calls`` trials: ``fitness`` returns one
    trial's recall (the reference's returns ``-recall``, main.py:513-527).

    optimizer: ``'gp'`` (GP-EI, the reference's algorithm) or ``'random'``.
    Resumes from the latest checkpoint in ``logdir`` unless
    ``from_beginning``; on resume the GP is told every finished trial.
    """
    state = SearchState(trials=[], seed=seed)
    if not from_beginning:
        ck = latest_checkpoint(logdir)
        if ck:
            state = load_checkpoint(ck)

    rng = np.random.default_rng(seed + len(state.trials))
    gp = None
    if optimizer == "gp":
        gp = GPOptimizer(Space(SEARCH_SPACE), x0=[dataclasses.asdict(HyperParams())],
                         seed=seed)
        for t in state.trials:  # replay history into the surrogate
            gp.tell(dataclasses.asdict(t.hyper), t.objective)
    os.makedirs(logdir, exist_ok=True)
    while len(state.trials) < n_calls:
        if gp is not None:
            hyper = HyperParams(**gp.ask())
        elif not state.trials:
            hyper = HyperParams()  # defaults-first (skopt x0)
        elif state.best is not None and rng.random() < exploit_prob:
            hyper = perturb_hyperparams(state.best.hyper, rng)
        else:
            hyper = sample_hyperparams(rng)
        recall = fitness(hyper)
        if gp is not None:
            gp.tell(dataclasses.asdict(hyper), -float(recall))
        state.trials.append(Trial(hyper=hyper, objective=-float(recall)))
        save_checkpoint(state, os.path.join(logdir, _checkpoint_name()))
        if verbose:
            get_logger(__name__).info("trial %d: recall=%.4f best=%.4f",
                                      len(state.trials), recall, -state.best.objective)
    return state
