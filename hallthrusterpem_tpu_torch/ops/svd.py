"""SVD rank selection for field compression (host side, numpy; the JAX
package's ``ops/svd.py``): a fixed ``rank``, an ``energy_tol`` (cumulative energy
fraction) or a ``reconstruction_tol`` (relative Frobenius reconstruction error).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def svd_rank(
    data_matrix: np.ndarray,
    rank: Optional[int] = None,
    energy_tol: Optional[float] = None,
    reconstruction_tol: Optional[float] = 0.01,
) -> tuple[np.ndarray, int]:
    """Left singular vectors of a ``(grid, snapshots)`` matrix and the retained rank.

    Non-finite snapshots (failed samples are NaN rows) are dropped first.

    :returns: ``(U, r)`` with ``U`` of shape ``(grid, min(grid, snapshots))``
    """
    A = np.asarray(data_matrix, dtype=np.float64)
    good = np.isfinite(A).all(axis=0)
    if not good.all():
        A = A[:, good]
    if A.shape[1] == 0:
        raise ValueError("no finite snapshots to build a compression map from")
    U, s, _ = np.linalg.svd(A, full_matrices=False)
    energy = s**2
    total = float(np.sum(energy))
    if total <= 0:
        return U, 1

    if rank is not None:
        r = int(min(rank, U.shape[1]))
    elif energy_tol is not None:
        frac = np.cumsum(energy) / total
        r = int(np.searchsorted(frac, 1.0 - 1e-15 if energy_tol >= 1 else energy_tol) + 1)
    else:
        tol = 0.01 if reconstruction_tol is None else reconstruction_tol
        # relative Frobenius error left after keeping r modes
        tail = np.sqrt(np.maximum(total - np.cumsum(energy), 0.0) / total)
        r = int(np.searchsorted(-tail, -tol) + 1)
    r = max(1, min(r, U.shape[1]))
    return U, r
