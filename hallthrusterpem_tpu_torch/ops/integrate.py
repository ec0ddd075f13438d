"""Composite-Simpson and trapezoid weights on a static grid, and the Simpson
integral with them (the JAX package's ``ops/integrate.py``)."""

from __future__ import annotations

import numpy as np
import torch


def simpson_weights(x: np.ndarray) -> np.ndarray:
    """Composite-Simpson weights for samples at (possibly non-uniform) points ``x``,
    matching ``scipy.integrate.simpson`` for even and odd sample counts."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    w = np.zeros(n)
    if n == 1:
        return w
    if n == 2:
        h = x[1] - x[0]
        return np.array([h / 2, h / 2])

    def _simpson_block(w, i0):
        h0 = x[i0 + 1] - x[i0]
        h1 = x[i0 + 2] - x[i0 + 1]
        hsum = h0 + h1
        w[i0] += hsum / 6.0 * (2.0 - h1 / h0)
        w[i0 + 1] += hsum / 6.0 * hsum**2 / (h0 * h1)
        w[i0 + 2] += hsum / 6.0 * (2.0 - h0 / h1)

    n_intervals = n - 1
    last_full = n_intervals - (n_intervals % 2)
    for i0 in range(0, last_full - 1, 2):
        _simpson_block(w, i0)
    if n_intervals % 2 == 1:
        # scipy's correction for the trailing odd interval (Cartwright formula)
        h0 = x[-2] - x[-3]
        h1 = x[-1] - x[-2]
        w[-1] += (2 * h1**2 + 3 * h0 * h1) / (6 * (h0 + h1))
        w[-2] += (h1**2 + 3 * h1 * h0) / (6 * h0)
        w[-3] -= h1**3 / (6 * h0 * (h0 + h1))
    return w


def simpson(y: torch.Tensor, x=None, weights=None, axis: int = -1) -> torch.Tensor:
    """Integrate ``y`` along ``axis`` with precomputed or on-the-fly Simpson
    weights. Each integral is the sum over its own row of ``y * weights``, so a
    row's value does not depend on how many rows the call holds (a BLAS
    matrix-vector product picks its kernel, and its rounding, by the batch)."""
    if weights is None:
        if x is None:
            raise ValueError("provide x or weights")
        weights = simpson_weights(np.asarray(x))
    w = torch.as_tensor(weights, dtype=y.dtype, device=y.device)
    return torch.sum(torch.movedim(y, axis, -1) * w, dim=-1)


def trapz_weights(x: np.ndarray) -> np.ndarray:
    """Trapezoid-rule weights for samples at (possibly non-uniform) points ``x``."""
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2
    w[1:] += dx / 2
    return w
