"""Failure-boundary classification and prior-domain trimming (a numpy copy of
the JAX package's ``surrogate/domain.py``; it reads the classifiers that package
saved).

The pem_v0 prior box contains regions where the solver legitimately fails
(quenched discharge at low flow/low anomalous transport, blown-up samples
NaN-masked by the physicality guards) — the same samples the reference
workflow sees as solver crashes and discards (reference ``gen_data.py:186``
"Discarded .../samples with nans"). Training interpolants against a box whose
corners fail, and spending Monte-Carlo/Sobol' draws there, wastes budget and
roughens the response surface. This module provides the cure recommended by
the reference's own domain guidance: fit a *cheap* classifier to the failure
boundary from already-labeled data, then reject-sample the prior to the
surviving domain.

The classifier is a quadratic-feature logistic regression — ~250 features in
the 21-dim normalized input space — trained with plain NumPy gradient descent
(no device round-trips; fitting takes milliseconds). For a sharper boundary,
the MLP surrogate's failure head (:meth:`~hallthrusterpem_tpu_torch.surrogate.mlp.
MLPSurrogate.fail_prob`) plugs into the same ``domain_filter`` protocol: any
callable mapping a sample dict to a boolean keep-mask.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

__all__ = ["FailureClassifier", "failure_mask", "make_domain_filter"]


def failure_mask(outputs: dict, skip: set | None = None) -> np.ndarray:
    """True where any (non-coords) float output of a sample is non-finite."""
    skip = skip or set()
    n = None
    for k, v in outputs.items():
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.dtype.kind == "f":
            n = arr.shape[0]
            break
    if n is None:
        return np.zeros(0, dtype=bool)
    fail = np.zeros(n, dtype=bool)
    for k, v in outputs.items():
        arr = np.asarray(v)
        if (arr.dtype.kind != "f" or arr.ndim == 0 or arr.shape[0] != n
                or k.endswith("_coords") or k in skip):
            continue
        fail |= ~np.isfinite(arr.reshape(n, -1)).all(axis=1)
    return fail


class FailureClassifier:
    """Quadratic-feature logistic regression on normalized inputs.

    ``prob(X)`` estimates P(solver failure); :meth:`keep_mask` thresholds it.
    """

    def __init__(self, var_names: list[str], threshold: float = 0.5):
        self.var_names = list(var_names)
        self.threshold = float(threshold)
        self.weights = None
        self.x_mu = None
        self.x_sd = None
        self.info: dict = {}

    # ------------------------------------------------------------------ features
    def _features(self, X: np.ndarray) -> np.ndarray:
        Xs = (X - self.x_mu) / self.x_sd
        n, d = Xs.shape
        iu, ju = np.triu_indices(d)
        quad = Xs[:, iu] * Xs[:, ju]
        return np.concatenate([np.ones((n, 1)), Xs, quad], axis=1)

    def pack(self, samples: dict, system=None, normalized: bool = False) -> np.ndarray:
        """Sample dict -> (N, D) matrix in normalized variable space (column
        order = ``self.var_names``). Pass the system to apply variable norms."""
        variables = {v.name: v for v in system.inputs()} if system is not None else {}
        cols = []
        for name in self.var_names:
            val = np.asarray(samples[name], dtype=np.float64).reshape(-1)
            var = variables.get(name)
            if var is not None and not normalized:
                val = np.asarray(var.normalize(val))
            cols.append(val)
        return np.stack(cols, axis=1)

    # ------------------------------------------------------------------ training
    def fit(self, X: np.ndarray, fail: np.ndarray, *, steps: int = 2000, lr: float = 0.3,
            l2: float = 1e-3, val_frac: float = 0.2, seed: int = 0) -> dict:
        X = np.asarray(X, dtype=np.float64)
        fail = np.asarray(fail, dtype=np.float64).reshape(-1)
        self.x_mu = X.mean(axis=0)
        self.x_sd = np.where(X.std(axis=0) > 1e-12, X.std(axis=0), 1.0)
        F = self._features(X)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(F))
        n_val = int(len(F) * val_frac)
        vi, ti = perm[:n_val], perm[n_val:]
        Ft, yt = F[ti], fail[ti]
        w = np.zeros(F.shape[1])
        m = np.zeros_like(w)  # momentum
        for i in range(steps):
            p = 1.0 / (1.0 + np.exp(-(Ft @ w)))
            g = Ft.T @ (p - yt) / len(yt) + l2 * w
            m = 0.9 * m + g
            w -= lr * m
        self.weights = w
        self.info = {"n_train": int(len(ti)), "fail_frac": float(fail.mean())}
        if n_val:
            pv = 1.0 / (1.0 + np.exp(-(F[vi] @ w)))
            pred = pv > self.threshold
            truth = fail[vi] > 0.5
            self.info["val_acc"] = float((pred == truth).mean())
            # recall on failures matters most: a missed failure pollutes training
            if truth.any():
                self.info["val_fail_recall"] = float((pred & truth).sum() / truth.sum())
        return self.info

    def fit_dataset(self, system, samples: dict, outputs: dict, **kwargs) -> dict:
        """Convenience: fit from a labeled ``(samples, outputs)`` dataset."""
        X = self.pack(samples, system=system)
        return self.fit(X, failure_mask(outputs, skip=set(samples)), **kwargs)

    # ------------------------------------------------------------------ inference
    def prob(self, X: np.ndarray) -> np.ndarray:
        if self.weights is None:
            raise ValueError("classifier is not fitted")
        return 1.0 / (1.0 + np.exp(-(self._features(np.asarray(X, dtype=np.float64)) @ self.weights)))

    def keep_mask(self, samples: dict, system=None, normalized: bool = False) -> np.ndarray:
        """True where a sample is predicted to survive the solver guards."""
        return self.prob(self.pack(samples, system=system, normalized=normalized)) < self.threshold

    def __call__(self, samples: dict, system=None) -> np.ndarray:
        return self.keep_mask(samples, system=system)

    # ------------------------------------------------------------------ io
    def to_state(self) -> dict:
        return {"var_names": self.var_names, "threshold": self.threshold,
                "weights": self.weights, "x_mu": self.x_mu, "x_sd": self.x_sd,
                "info": self.info}

    @classmethod
    def from_state(cls, state: dict) -> "FailureClassifier":
        clf = cls(state["var_names"], threshold=state["threshold"])
        clf.weights, clf.x_mu, clf.x_sd = state["weights"], state["x_mu"], state["x_sd"]
        clf.info = state.get("info", {})
        return clf

    def save(self, path):
        with open(path, "wb") as fd:
            pickle.dump(self.to_state(), fd)

    @classmethod
    def load(cls, path) -> "FailureClassifier":
        with open(Path(path), "rb") as fd:
            return cls.from_state(pickle.load(fd))


def make_domain_filter(classifier, system) -> callable:
    """Bind a classifier to a system as a ``domain_filter`` for
    :meth:`System.sample_inputs`: ``samples dict -> keep mask``."""
    def domain_filter(samples: dict) -> np.ndarray:
        return classifier.keep_mask(samples, system=system)
    return domain_filter
