"""1-D linear interpolation on a sorted grid (the JAX package's ``ops/interp.py``)."""

from __future__ import annotations

import torch


def interp1d(xq: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``fp`` (defined at sorted points ``xp``) at ``xq``,
    clamped to the endpoint values. Batched over leading axes of ``fp``."""
    idx = torch.clamp(torch.searchsorted(xp, xq, right=True) - 1, 0, xp.shape[0] - 2)
    x0 = xp[idx]
    x1 = xp[idx + 1]
    w = torch.where(x1 > x0, (xq - x0) / (x1 - x0), torch.zeros_like(xq))
    w = torch.clamp(w, 0.0, 1.0)
    return fp[..., idx] * (1 - w) + fp[..., idx + 1] * w
