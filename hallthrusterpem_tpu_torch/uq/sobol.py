"""Sobol' sensitivity analysis by Saltelli sampling (the JAX package's
``uq/sobol.py``): the N*(d+2) rows of the Saltelli design go through the model
as ONE batch, so on the card one surrogate call covers the whole design.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from hallthrusterpem_tpu_torch.core.dataset import to_numpy

__all__ = ["sobol_sa", "saltelli_matrices"]


def saltelli_matrices(sampler: Callable, n: int, d: int, seed: int = 0):
    """A, B and the d AB_i matrices from an i.i.d. sampler
    ``sampler(n, seed) -> (n, d)`` (numpy or a tensor)."""
    A = to_numpy(sampler(n, seed))
    B = to_numpy(sampler(n, seed + 1))
    assert A.shape == (n, d) and B.shape == (n, d)
    ABs = []
    for i in range(d):
        AB = A.copy()
        AB[:, i] = B[:, i]
        ABs.append(AB)
    return A, B, ABs


def sobol_sa(
    fn: Callable,
    sampler: Callable,
    n_samples: int,
    d: int,
    qoi_names: Optional[Sequence[str]] = None,
    seed: int = 0,
    compute_s2: bool = False,
):
    """First-order (S1, Saltelli 2010) and total-order (ST, Jansen) Sobol'
    indices; samples where any model output is not finite are left out.

    :param fn: batched model, called once on the (N*(d+2), d) numpy design:
        returns (N,), (N, q) or a dict of (N,) arrays, as numpy or tensors
    :param sampler: ``sampler(n, seed) -> (n, d)`` i.i.d. input sampler
    :returns: dict with 'S1' (d, q), 'ST' (d, q), 'qois', 'variance', 'mean'
    """
    A, B, ABs = saltelli_matrices(sampler, n_samples, d, seed)
    big = np.concatenate([A, B] + ABs, axis=0)
    out = fn(big)

    if isinstance(out, dict):
        names = list(qoi_names or out.keys())
        cols = [np.asarray(to_numpy(out[k]), dtype=np.float64).reshape(big.shape[0], -1)[:, 0] for k in names]
        Y = np.stack(cols, axis=-1)
    else:
        Y = np.asarray(to_numpy(out), dtype=np.float64)
        if Y.ndim == 1:
            Y = Y[:, None]
        names = list(qoi_names or [f"qoi{i}" for i in range(Y.shape[1])])

    n = n_samples
    fA = Y[:n]
    fB = Y[n : 2 * n]
    fABs = [Y[(2 + i) * n : (3 + i) * n] for i in range(d)]

    valid = np.isfinite(fA) & np.isfinite(fB)
    for fAB in fABs:
        valid &= np.isfinite(fAB)

    fall = np.concatenate([np.where(valid, fA, np.nan), np.where(valid, fB, np.nan)])
    mean = np.nanmean(fall, axis=0)
    var = np.nanvar(fall, axis=0)
    var = np.maximum(var, 1e-300)

    S1 = np.empty((d, Y.shape[1]))
    ST = np.empty((d, Y.shape[1]))
    for i, fAB in enumerate(fABs):
        dB = np.where(valid, fB * (fAB - fA), np.nan)  # Saltelli 2010 S1 estimator
        dT = np.where(valid, (fA - fAB) ** 2, np.nan)  # Jansen ST estimator
        S1[i] = np.nanmean(dB, axis=0) / var
        ST[i] = 0.5 * np.nanmean(dT, axis=0) / var

    return {"S1": S1, "ST": ST, "qois": names, "variance": var, "mean": mean}
