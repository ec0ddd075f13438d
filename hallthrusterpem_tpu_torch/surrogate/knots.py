"""Nested 1-D interpolation knots (Leja sequences) + barycentric weights (a numpy
copy of the JAX package's ``surrogate/knots.py``).

The reference's surrogate engine (external ``amisc``; SURVEY.md §2.4) trains
sparse-grid Lagrange interpolants with ``knots_per_level`` nested points per
refinement level (``pem_v0_SPT-100.yml:107-109``). We use greedy Leja sequences —
nested by construction (level ``b`` uses the first ``k*b + 1`` points), stable for
high-degree interpolation, and trivially mapped to any bounded domain.
"""

from __future__ import annotations

import numpy as np

__all__ = ["leja_sequence", "knots_for_level", "barycentric_weights"]

_CACHE: dict[int, np.ndarray] = {}


def leja_sequence(n: int, num_candidates: int = 4001) -> np.ndarray:
    """First ``n`` points of a greedy Leja sequence on [-1, 1] (float64).

    x0 = 0; x_k = argmax_x prod_j |x - x_j| over a fine candidate grid.
    """
    if n in _CACHE:
        return _CACHE[n][:n]
    have = max(_CACHE.keys(), default=0)
    if have >= n:
        best = _CACHE[have]
        _CACHE[n] = best[:n]
        return _CACHE[n]

    cand = np.linspace(-1.0, 1.0, num_candidates)
    pts = np.zeros(n)
    pts[0] = 0.0
    # log-product for numerical stability
    logprod = np.log(np.abs(cand - pts[0]) + 1e-300)
    for k in range(1, n):
        idx = int(np.argmax(logprod))
        pts[k] = cand[idx]
        logprod += np.log(np.abs(cand - pts[k]) + 1e-300)
    _CACHE[n] = pts
    return pts


def knots_for_level(level: int, knots_per_level: int = 2, domain=(-1.0, 1.0)) -> np.ndarray:
    """Nested knot set for a refinement level: ``knots_per_level*level + 1`` Leja
    points mapped to ``domain``."""
    n = knots_per_level * int(level) + 1
    x = leja_sequence(n)
    lo, hi = domain
    return lo + (x + 1.0) * 0.5 * (hi - lo)


def barycentric_weights(x: np.ndarray) -> np.ndarray:
    """Barycentric interpolation weights for nodes ``x`` (rescaled to max 1)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if n == 1:
        return np.ones(1)
    # scale nodes to O(1) spread to avoid under/overflow in the products
    scale = 4.0 / max(x.max() - x.min(), 1e-300)
    w = np.ones(n)
    for i in range(n):
        diff = (x[i] - np.delete(x, i)) * scale
        w[i] = 1.0 / np.prod(diff)
    return w / np.max(np.abs(w))
