"""The plain reference of the test-only operation ``mlp_operation.py``: its
weights, drawn from the seed, and the network in any precision, with plain
torch on the CPU. The tests put it in a copied tree as
``pembench/reference/mlp_test.py``."""

from __future__ import annotations

import numpy as np
import torch


def weights(widths: list, seed: int) -> list:
    """(W, b) of each layer, float64, drawn from the seed."""
    rng = np.random.default_rng([seed, 3])
    return [(rng.standard_normal((a, b)) / np.sqrt(a), 0.1 * rng.standard_normal(b))
            for a, b in zip(widths[:-1], widths[1:])]


def forward(layers: list, x: np.ndarray, dtype=torch.float64) -> np.ndarray:
    """The network's outputs for the rows ``x``, computed in ``dtype``, as float64."""
    h = torch.as_tensor(np.asarray(x, np.float64)).to(dtype)
    for i, (w, b) in enumerate(layers):
        h = h @ torch.as_tensor(w).to(dtype) + torch.as_tensor(b).to(dtype)
        h = h.tanh() if i < len(layers) - 1 else h
    return h.to(torch.float64).numpy()
