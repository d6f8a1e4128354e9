"""Gaussian-process Bayesian optimizer (GP + expected improvement) in numpy.

Port of ``gnn_recsys_tpu/gp_opt.py``, the stand-in for the reference's
``gp_minimize(fitness, dims, n_calls=200, acq_func='EI', x0=defaults,
random_state=46)`` (reference ``main.py:577-606``): skopt-style encoding of
the space (floats min-max normalised, optionally in log space, ints
normalised, categoricals one-hot), a Matern-5/2 GP with white noise whose
hyperparameters come from a marginal-likelihood grid, and EI maximised over
random candidates and perturbations of the incumbent.  The caller's ``x0``
is asked first, then random points up to ``n_initial_points``.

The code and the order of its draws are the JAX package's, so the same seed
and the same tells give the same asks in both packages.  It runs on the host
between trials.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Space encoding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Dim:
    name: str
    kind: str  # 'float' | 'int' | 'cat'
    lo: float = 0.0
    hi: float = 1.0
    log: bool = False
    choices: Tuple = ()

    @property
    def width(self) -> int:
        return len(self.choices) if self.kind == "cat" else 1


class Space:
    """Mixed search space <-> unit-cube encoding.

    spec: name -> ('float', lo, hi, log) | ('int', lo, hi) |
                  ('cat', [choices...]).
    Encoded vector layout: floats/ints one coordinate in [0, 1]; categoricals
    one-hot (skopt's default Categorical transform).
    """

    def __init__(self, spec: Dict[str, Tuple]):
        dims: List[_Dim] = []
        for name, s in spec.items():
            if s[0] == "cat":
                dims.append(_Dim(name, "cat", choices=tuple(s[1])))
            elif s[0] == "float":
                log = bool(s[3]) if len(s) > 3 else False
                dims.append(_Dim(name, "float", float(s[1]), float(s[2]), log))
            elif s[0] == "int":
                dims.append(_Dim(name, "int", float(s[1]), float(s[2])))
            else:
                raise ValueError(f"unknown dim kind {s[0]!r} for {name!r}")
        self.dims = dims
        self.encoded_width = sum(d.width for d in dims)

    def encode(self, params: Dict) -> np.ndarray:
        out = np.zeros(self.encoded_width, dtype=np.float64)
        j = 0
        for d in self.dims:
            v = params[d.name]
            if d.kind == "cat":
                out[j + d.choices.index(v)] = 1.0
                j += d.width
            else:
                lo, hi = d.lo, d.hi
                x = float(v)
                if d.log:
                    x, lo, hi = np.log(x), np.log(lo), np.log(hi)
                out[j] = (x - lo) / (hi - lo)
                j += 1
        return out

    def decode(self, x: np.ndarray) -> Dict:
        params = {}
        j = 0
        for d in self.dims:
            if d.kind == "cat":
                params[d.name] = d.choices[int(np.argmax(x[j:j + d.width]))]
                j += d.width
            else:
                lo, hi = d.lo, d.hi
                if d.log:
                    lo, hi = np.log(lo), np.log(hi)
                v = lo + float(np.clip(x[j], 0.0, 1.0)) * (hi - lo)
                if d.log:
                    v = float(np.exp(v))
                params[d.name] = int(round(v)) if d.kind == "int" else float(v)
                j += 1
        return params

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        """n random points, already in encoded (one-hot) form."""
        out = np.zeros((n, self.encoded_width), dtype=np.float64)
        j = 0
        for d in self.dims:
            if d.kind == "cat":
                choice = rng.integers(0, d.width, size=n)
                out[np.arange(n), j + choice] = 1.0
                j += d.width
            else:
                out[:, j] = rng.uniform(0.0, 1.0, size=n)
                j += 1
        return out

    def perturb(
        self, x: np.ndarray, rng: np.random.Generator, scale: float = 0.15
    ) -> np.ndarray:
        """Local move: jitter numeric coords, occasionally flip a categorical."""
        y = x.copy()
        j = 0
        for d in self.dims:
            if d.kind == "cat":
                if rng.random() < 0.2:
                    y[j:j + d.width] = 0.0
                    y[j + rng.integers(0, d.width)] = 1.0
                j += d.width
            else:
                y[j] = np.clip(y[j] + rng.normal(0.0, scale), 0.0, 1.0)
                j += 1
        return y


# ---------------------------------------------------------------------------
# Matern-5/2 GP
# ---------------------------------------------------------------------------


def _matern52(
    a: np.ndarray, b: np.ndarray, lengthscale: float, variance: float
) -> np.ndarray:
    d = np.sqrt(
        np.maximum(
            np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
            - 2.0 * (a @ b.T),
            0.0,
        )
    )
    s = np.sqrt(5.0) * d / lengthscale
    return variance * (1.0 + s + s * s / 3.0) * np.exp(-s)


class _GP:
    """Zero-mean GP on standardized targets; hyperparams fit by grid MLE."""

    def __init__(self, x: np.ndarray, y: np.ndarray, seed: int = 0):
        self.x = x
        self.y_mean = float(np.mean(y))
        self.y_std = float(np.std(y)) or 1.0
        self.y = (y - self.y_mean) / self.y_std
        self._fit(seed)

    def _fit(self, seed: int) -> None:
        n, w = self.x.shape
        best = (np.inf, 1.0, 1e-3)
        # Coarse MLE grid: lengthscale relative to the unit cube diagonal,
        # noise floor relative to standardized target variance (== 1).
        for ls in np.sqrt(w) * np.array([0.1, 0.2, 0.4, 0.8, 1.6]):
            for noise in (1e-4, 1e-2, 1e-1):
                k = _matern52(self.x, self.x, ls, 1.0)
                k[np.diag_indices(n)] += noise
                try:
                    chol = np.linalg.cholesky(k)
                except np.linalg.LinAlgError:
                    continue
                alpha = np.linalg.solve(
                    chol.T, np.linalg.solve(chol, self.y)
                )
                nll = (
                    0.5 * float(self.y @ alpha)
                    + float(np.sum(np.log(np.diag(chol))))
                )
                if nll < best[0]:
                    best = (nll, ls, noise)
        _, self.ls, self.noise = best
        k = _matern52(self.x, self.x, self.ls, 1.0)
        k[np.diag_indices(n)] += self.noise
        self.chol = np.linalg.cholesky(k)
        self.alpha = np.linalg.solve(
            self.chol.T, np.linalg.solve(self.chol, self.y)
        )

    def predict(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        kq = _matern52(xq, self.x, self.ls, 1.0)  # [Q, N]
        mu = kq @ self.alpha
        v = np.linalg.solve(self.chol, kq.T)  # [N, Q]
        var = np.maximum(1.0 - np.sum(v * v, axis=0), 1e-12)
        return (
            mu * self.y_std + self.y_mean,
            np.sqrt(var) * self.y_std,
        )


def _phi_Phi(z: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Standard normal pdf and cdf (erf via scipy-free vectorized math)."""
    pdf = np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)
    # erf on arrays without scipy: numpy lacks it, use the tanh-free
    # Abramowitz-Stegun 7.1.26 rational approximation (|err| < 1.5e-7).
    t = 1.0 / (1.0 + 0.3275911 * np.abs(z) / np.sqrt(2.0))
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429)))
    )
    erf = 1.0 - poly * np.exp(-0.5 * z * z)
    cdf = 0.5 * (1.0 + np.sign(z) * erf)
    return pdf, cdf


def expected_improvement(
    mu: np.ndarray, sigma: np.ndarray, best: float, xi: float = 0.01
) -> np.ndarray:
    """EI for MINIMIZATION (skopt's acq_func='EI' convention)."""
    imp = best - mu - xi
    z = imp / np.maximum(sigma, 1e-12)
    pdf, cdf = _phi_Phi(z)
    return np.where(sigma > 1e-12, imp * cdf + sigma * pdf, 0.0)


# ---------------------------------------------------------------------------
# Ask/tell optimizer
# ---------------------------------------------------------------------------


class GPOptimizer:
    """gp_minimize-style ask/tell loop over a mixed space.

    - first ``len(x0)`` asks return the caller-provided initial points;
    - the next asks up to ``n_initial_points`` total are random;
    - afterwards each ask refits the GP and maximizes EI over
      ``n_candidates`` random points + perturbations of the incumbent
      (gradient-free acq optimization — the one-hot blocks make the space
      piecewise, so candidate search beats L-BFGS here).
    Objectives are MINIMIZED.
    """

    def __init__(
        self,
        space: Space,
        x0: Optional[Sequence[Dict]] = None,
        n_initial_points: int = 10,
        n_candidates: int = 2048,
        xi: float = 0.01,
        seed: int = 46,
    ):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.x0 = [dict(p) for p in (x0 or [])]  # returned verbatim by ask()
        self.n_initial_points = max(n_initial_points, len(self.x0))
        self.n_candidates = n_candidates
        self.xi = xi
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []

    def ask(self) -> Dict:
        n = len(self.xs)
        if n < len(self.x0):
            return dict(self.x0[n])
        if n < self.n_initial_points:
            return self.space.decode(self.space.sample(self.rng)[0])
        x = np.stack(self.xs)
        y = np.asarray(self.ys)
        gp = _GP(x, y)
        cand = self.space.sample(self.rng, self.n_candidates)
        best_idx = int(np.argmin(y))
        local = np.stack(
            [
                self.space.perturb(x[best_idx], self.rng)
                for _ in range(self.n_candidates // 4)
            ]
        )
        cand = np.concatenate([cand, local], axis=0)
        mu, sigma = gp.predict(cand)
        ei = expected_improvement(mu, sigma, float(np.min(y)), self.xi)
        return self.space.decode(cand[int(np.argmax(ei))])

    def tell(self, params: Dict, objective: float) -> None:
        self.xs.append(self.space.encode(params))
        self.ys.append(float(objective))

    @property
    def best(self) -> Tuple[Optional[Dict], float]:
        if not self.ys:
            return None, np.inf
        i = int(np.argmin(self.ys))
        return self.space.decode(self.xs[i]), self.ys[i]
