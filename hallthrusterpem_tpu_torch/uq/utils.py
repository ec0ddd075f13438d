"""Helpers of the calibration scripts (the JAX package's ``uq/utils.py``):
finite-difference Hessian, positive-definite repair, normal sampling, Laplace
approximation and MLE. numpy and scipy on the host; a function handed in may
return a tensor on the card, converted to numpy once per call.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from hallthrusterpem_tpu_torch.core.dataset import to_numpy

__all__ = [
    "approx_hess",
    "is_positive_definite",
    "nearest_positive_definite",
    "normal_sample",
    "laplace_approximation",
    "run_mle",
]


def approx_hess(fn: Callable, x0: np.ndarray, rel_step: float = 1e-4,
                steps: np.ndarray | None = None) -> np.ndarray:
    """Central finite-difference Hessian of a scalar function, evaluated with ONE
    batched call of ``fn`` over all 2d^2 + 1 stencil points.

    ``steps`` (absolute per-dimension stencil sizes) overrides the relative rule.
    Pass problem-scaled steps (a few percent of each prior width) when ``fn`` is
    a float32 program: a float32 log-posterior of magnitude ~1e4 resolves ~1e-3,
    and |x0|-relative stencils can give differences below that."""
    x0 = np.asarray(x0, dtype=np.float64)
    d = x0.size
    h = np.asarray(steps, dtype=np.float64) if steps is not None \
        else rel_step * np.maximum(np.abs(x0), 1.0)

    pts = [x0]
    for i in range(d):
        for j in range(i, d):
            for si, sj in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
                p = x0.copy()
                p[i] += si * h[i]
                p[j] += sj * h[j]
                pts.append(p)
    vals = to_numpy(fn(np.stack(pts)))
    H = np.zeros((d, d))
    k = 1
    for i in range(d):
        for j in range(i, d):
            fpp, fpm, fmp, fmm = vals[k], vals[k + 1], vals[k + 2], vals[k + 3]
            k += 4
            H[i, j] = H[j, i] = (fpp - fpm - fmp + fmm) / (4 * h[i] * h[j])
    return H


def is_positive_definite(A: np.ndarray) -> bool:
    try:
        np.linalg.cholesky(A)
        return True
    except np.linalg.LinAlgError:
        return False


def nearest_positive_definite(A: np.ndarray) -> np.ndarray:
    """Higham's nearest symmetric positive-definite matrix."""
    B = (A + A.T) / 2
    _, s, V = np.linalg.svd(B)
    H = V.T @ np.diag(s) @ V
    A2 = (B + H) / 2
    A3 = (A2 + A2.T) / 2
    if is_positive_definite(A3):
        return A3
    spacing = np.spacing(np.linalg.norm(A))
    eye = np.eye(A.shape[0])
    k = 1
    while not is_positive_definite(A3):
        mineig = np.min(np.real(np.linalg.eigvals(A3)))
        A3 += eye * (-mineig * k**2 + spacing)
        k += 1
    return A3


def normal_sample(mean, cov, size: int, seed: int = 0) -> np.ndarray:
    """Multivariate normal samples through a Cholesky factor of the covariance,
    repaired to positive definite first where it is not (numpy's
    ``multivariate_normal`` would warn on repaired matrices near the float64
    floor)."""
    mean = np.atleast_1d(np.asarray(mean, dtype=np.float64))
    cov = np.atleast_2d(np.asarray(cov, dtype=np.float64))
    if not is_positive_definite(cov):
        cov = nearest_positive_definite(cov)
    chol = np.linalg.cholesky(cov)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((size, mean.shape[0]))
    return mean + z @ chol.T


def laplace_approximation(log_post: Callable, x_map: np.ndarray, rel_step: float = 1e-4,
                          steps: np.ndarray | None = None):
    """Gaussian (Laplace) approximation at a MAP point: N(x_map, -H^{-1}).

    Flat or negatively-curved directions make ``-H`` singular; their eigenvalues
    are floored at 1e-8 of the stiffest direction, so they come back with a large
    but finite variance."""
    H = approx_hess(log_post, x_map, rel_step=rel_step, steps=steps)
    A = -0.5 * (H + H.T)
    w, V = np.linalg.eigh(A)
    top = float(w.max())
    if not np.isfinite(top) or top <= 0.0:
        raise ValueError("laplace_approximation: no positive curvature at x_map "
                         "(posterior locally flat or x_map not a mode)")
    w = np.maximum(w, 1e-8 * top)
    cov = (V / w) @ V.T
    return np.asarray(x_map, dtype=np.float64), cov


def run_mle(
    neg_log_post: Callable,
    x0: np.ndarray,
    bounds=None,
    method: str = "Nelder-Mead",
    **kwargs,
):
    """MAP optimization with scipy. ``neg_log_post`` takes a single point and
    returns a number; ``method="differential_evolution"`` calls it on batches
    (``vectorized=True``) and needs ``bounds``."""
    from scipy.optimize import differential_evolution, minimize

    if method == "differential_evolution":
        if bounds is None:
            raise ValueError("differential_evolution requires bounds")
        return differential_evolution(neg_log_post, bounds=bounds, vectorized=True, **kwargs)
    return minimize(neg_log_post, np.asarray(x0, dtype=np.float64), method=method, bounds=bounds, **kwargs)
