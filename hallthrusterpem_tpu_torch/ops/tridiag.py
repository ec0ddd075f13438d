"""Batched tridiagonal solvers (the JAX package's ``ops/tridiag.py``).

The lax solver's backward-Euler electron-energy update needs one tridiagonal
solve per step and sample. Parallel cyclic reduction (PCR) does it in
ceil(log2 N) sweeps of elementwise operations over the whole (batch, N) tensor;
the sequential Thomas sweep is kept as the reference it is tested against.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _shifted(arr: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """``arr`` shifted so ``out[..., i] = arr[..., i + k]``, out-of-range reads
    ``fill`` (last axis)."""
    if k == 0:
        return arr
    if k > 0:
        return F.pad(arr, (0, k), value=fill)[..., k:]
    return F.pad(arr, (-k, 0), value=fill)[..., :k]


def tridiag_solve(a, b, c, d) -> torch.Tensor:
    """Solve ``a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]`` along the last axis
    by parallel cyclic reduction; any leading axes are batch axes.

    ``a[..., 0]`` and ``c[..., -1]`` are ignored (zeroed). Every row is divided
    by its diagonal first, which keeps each PCR intermediate at the row's own
    magnitude: float32 stays finite when the coefficients span many decades."""
    n = a.shape[-1]
    a = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], dim=-1)
    c = torch.cat([c[..., :-1], torch.zeros_like(c[..., :1])], dim=-1)
    inv = 1.0 / b
    a = a * inv
    c = c * inv
    d = d * inv
    b = torch.ones_like(b)

    steps = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    k = 1
    for _ in range(steps):
        am, bm, cm, dm = (_shifted(x, -k, fill) for x, fill in ((a, 0.0), (b, 1.0), (c, 0.0), (d, 0.0)))
        ap, bp, cp, dp = (_shifted(x, k, fill) for x, fill in ((a, 0.0), (b, 1.0), (c, 0.0), (d, 0.0)))
        alpha = -a / bm
        beta = -c / bp
        a = alpha * am
        c = beta * cp
        b = b + alpha * cm + beta * ap
        d = d + alpha * dm + beta * dp
        k *= 2
    return d / b


def thomas_solve(a, b, c, d) -> torch.Tensor:
    """The same systems by the sequential Thomas algorithm (O(N) serial steps;
    the reference :func:`tridiag_solve` is tested against)."""
    n = a.shape[-1]
    zeros = torch.zeros_like(b[..., 0])
    cps, dps = [], []
    cp_prev, dp_prev = zeros, zeros
    for i in range(n):
        denom = b[..., i] - a[..., i] * cp_prev
        cp_prev = c[..., i] / denom
        dp_prev = (d[..., i] - a[..., i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    xs = [None] * n
    x_next = zeros
    for i in reversed(range(n)):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)
