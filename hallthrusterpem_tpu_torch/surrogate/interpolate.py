"""Tensor-product interpolation on nested Leja grids (the JAX package's
``surrogate/interpolate.py``).

One ``TensorInterpolant`` holds the full tensor of training values on the
cartesian product of per-dimension knots. It evaluates on the host in numpy
(interpolant tensors are tiny and the MISC trainer calls them in tight loops);
:func:`eval_tensor` is the batched torch twin that a trained surrogate runs on
the device: per dimension one ``(N, n_d)`` factor matrix (barycentric Lagrange or
piecewise-linear hat weights), contracted against the value tensor in turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from hallthrusterpem_tpu_torch.surrogate.knots import barycentric_weights

__all__ = ["TensorInterpolant", "tensor_grid_points", "eval_tensor"]


def tensor_grid_points(knots_1d: Sequence[np.ndarray]) -> np.ndarray:
    """Cartesian product of per-dim knot vectors -> (num_points, d) array (C order:
    last dim fastest)."""
    grids = np.meshgrid(*knots_1d, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


@dataclass
class TensorInterpolant:
    """Tensor-product interpolant on nested Leja grids.

    :param knots: per-dim node vectors (lengths n_1..n_d)
    :param values: (n_1, ..., n_d, n_out) training values on the tensor grid
    :param method: ``"lagrange"`` (global barycentric polynomial per dim) or
        ``"linear"`` (piecewise-linear hat basis per dim: local support, constant
        beyond the end knots). Both are interpolatory on nested knots, so the
        MISC combination telescopes identically.
    """

    knots: tuple
    values: np.ndarray
    method: str = "lagrange"

    def __post_init__(self):
        self.knots = tuple(np.asarray(k, dtype=np.float64) for k in self.knots)
        if self.method == "linear":
            # hat-basis evaluation needs sorted nodes: sort each dim's knots and
            # permute the value tensor's axes to match, once
            order = tuple(np.argsort(k) for k in self.knots)
            self.knots = tuple(k[o] for k, o in zip(self.knots, order))
            vals = np.asarray(self.values)
            for d, o in enumerate(order):
                vals = np.take(vals, o, axis=d)
            self.values = vals
            self._weights = tuple(np.ones_like(k) for k in self.knots)  # unused
        else:
            self._weights = tuple(barycentric_weights(k) for k in self.knots)

    @property
    def ndim(self) -> int:
        return len(self.knots)

    @property
    def n_out(self) -> int:
        return self.values.shape[-1]

    def grid_points(self) -> np.ndarray:
        return tensor_grid_points(self.knots)

    def __call__(self, x):
        """Evaluate at ``x`` of shape (..., d) -> (..., n_out), in numpy on the host."""
        x = np.asarray(x, dtype=np.float64)
        batch_shape = x.shape[:-1]
        xq = x.reshape((-1, self.ndim))
        if self.method == "linear":
            out = _eval_tensor_linear_np(self.knots, np.asarray(self.values), xq)
        else:
            out = _eval_tensor_np(self.knots, self._weights, np.asarray(self.values), xq)
        return out.reshape(batch_shape + (self.values.shape[-1],))


def _eval_tensor_np(knots, weights, values, xq: np.ndarray) -> np.ndarray:
    """Vectorized NumPy barycentric tensor contraction: ``xq`` (N, d) -> (N, n_out)."""
    v = None
    for d, (kn, w) in enumerate(zip(knots, weights)):
        diff = xq[:, d : d + 1] - kn[None, :]  # (N, n_d)
        near = np.abs(diff) < 1e-13 * (1.0 + np.abs(kn)[None, :])
        any_near = near.any(axis=1, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = w[None, :] / np.where(near, 1.0, diff)
            smooth = terms / terms.sum(axis=1, keepdims=True)
        exact = near.astype(np.float64)
        exact /= np.maximum(exact.sum(axis=1, keepdims=True), 1.0)
        L = np.where(any_near, exact, smooth)  # (N, n_d) factor matrix
        if v is None:
            v = np.tensordot(L, values, axes=(1, 0))  # (N, n_2, ..., n_out)
        else:
            v = np.einsum("bi,bi...->b...", L, v)
    return v


def _linear_factor_np(kn: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Piecewise-linear hat weights: ``q`` (N,) on sorted nodes ``kn`` (n,) ->
    (N, n) factor matrix (rows sum to 1; constant beyond the end nodes)."""
    n = kn.size
    out = np.zeros((q.size, n))
    if n == 1:
        out[:, 0] = 1.0
        return out
    qc = np.clip(q, kn[0], kn[-1])
    hi = np.clip(np.searchsorted(kn, qc, side="right"), 1, n - 1)
    lo = hi - 1
    t = (qc - kn[lo]) / np.maximum(kn[hi] - kn[lo], 1e-300)
    rows = np.arange(q.size)
    out[rows, lo] = 1.0 - t
    out[rows, hi] += t
    return out


def _eval_tensor_linear_np(knots, values, xq: np.ndarray) -> np.ndarray:
    """Piecewise-multilinear tensor contraction: ``xq`` (N, d) -> (N, n_out)."""
    v = None
    for d, kn in enumerate(knots):
        L = _linear_factor_np(kn, xq[:, d])
        if v is None:
            v = np.tensordot(L, values, axes=(1, 0))
        else:
            v = np.einsum("bi,bi...->b...", L, v)
    return v


def _lagrange_factor(q: torch.Tensor, nodes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Barycentric Lagrange weights of ``q`` (N,) on ``nodes`` (n,) -> (N, n); a
    query on a node takes that node's value exactly."""
    diff = q[:, None] - nodes[None, :]
    near = diff.abs() < 1e-13 * (1.0 + nodes.abs()[None, :])
    terms = w[None, :] / torch.where(near, torch.ones_like(diff), diff)
    smooth = terms / terms.sum(dim=1, keepdim=True)
    exact = near.to(q.dtype)
    exact = exact / exact.sum(dim=1, keepdim=True).clamp_min(1.0)
    return torch.where(near.any(dim=1, keepdim=True), exact, smooth)


def _linear_factor(q: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear hat weights of ``q`` (N,) on sorted ``nodes`` (n,) -> (N, n)."""
    n = nodes.shape[0]
    if n == 1:
        return torch.ones((q.shape[0], 1), dtype=q.dtype, device=q.device)
    qc = torch.clamp(q, nodes[0], nodes[-1])
    hi = torch.clamp(torch.searchsorted(nodes, qc, right=True), 1, n - 1)
    lo = hi - 1
    t = (qc - nodes[lo]) / torch.clamp_min(nodes[hi] - nodes[lo], 1e-300)
    out = torch.zeros((q.shape[0], n), dtype=q.dtype, device=q.device)
    out.scatter_add_(1, lo[:, None], (1.0 - t)[:, None])
    return out.scatter_add_(1, hi[:, None], t[:, None])


def eval_tensor(knots, weights, values: torch.Tensor, xq: torch.Tensor, method: str = "lagrange") -> torch.Tensor:
    """Batched tensor-product evaluation on the device of ``xq``: ``xq`` (N, d) ->
    (N, n_out), in the dtype of ``values``.

    :param knots: per-dim node tensors (sorted, for ``method="linear"``)
    :param weights: per-dim barycentric weight tensors (unused for ``"linear"``)
    :param values: (n_1, ..., n_d, n_out) value tensor
    """
    n = xq.shape[0]
    v = values.reshape(values.shape[0], -1)
    for d, (nodes, w) in enumerate(zip(knots, weights)):
        q = xq[:, d]
        L = _linear_factor(q, nodes) if method == "linear" else _lagrange_factor(q, nodes, w)
        if d == 0:
            v = L @ v  # (N, n_2 * ... * n_out)
        else:
            v = torch.bmm(L[:, None, :], v.reshape(n, nodes.shape[0], -1))[:, 0]
    return v.reshape(n, values.shape[-1])
