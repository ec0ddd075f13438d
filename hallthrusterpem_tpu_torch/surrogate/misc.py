"""Multi-Index Stochastic Collocation (MISC) index-set machinery (a copy of the
JAX package's ``surrogate/misc.py``).

Downward-closed sets of combined multi-indices ``(alpha | beta)`` (model fidelity x
surrogate/grid fidelity) with inclusion-exclusion combination coefficients — the
data structures the reference replays explicitly at ``scripts/pem_v0/monte_carlo.py:716-767``
(its clearest in-repo spec; the implementation lived in the external ``amisc``).
All host-side control logic: tiny tuples, no arrays.
"""

from __future__ import annotations

from itertools import product
from typing import Iterable, Sequence

__all__ = [
    "combine_index",
    "split_index",
    "is_downward_closed",
    "candidate_neighbors",
    "combination_coefficients",
]


def combine_index(alpha: tuple, beta: tuple) -> tuple:
    return tuple(alpha) + tuple(beta)


def split_index(kappa: tuple, n_alpha: int) -> tuple[tuple, tuple]:
    return tuple(kappa[:n_alpha]), tuple(kappa[n_alpha:])


def is_downward_closed(indices: Iterable[tuple]) -> bool:
    s = set(indices)
    for kappa in s:
        for d, k in enumerate(kappa):
            if k > 0:
                lower = kappa[:d] + (k - 1,) + kappa[d + 1 :]
                if lower not in s:
                    return False
    return True


def candidate_neighbors(active: set, max_levels: Sequence[int]) -> set:
    """Forward neighbors of the active set that keep it downward-closed and within
    per-dimension level caps."""
    out = set()
    for kappa in active:
        for d in range(len(kappa)):
            cand = kappa[:d] + (kappa[d] + 1,) + kappa[d + 1 :]
            if cand in active or cand[d] > max_levels[d]:
                continue
            # downward-closed check: all backward neighbors must be active
            ok = True
            for dd, k in enumerate(cand):
                if k > 0:
                    lower = cand[:dd] + (k - 1,) + cand[dd + 1 :]
                    if lower not in active:
                        ok = False
                        break
            if ok:
                out.add(cand)
    return out


def combination_coefficients(indices: Iterable[tuple]) -> dict[tuple, int]:
    """Inclusion-exclusion coefficients: c_k = sum_{e in {0,1}^d, k+e in S} (-1)^|e|.
    Entries with c == 0 are dropped.

    Instead of enumerating all 2^d unit-box corners (2^14 for the 12-input
    thruster), walk the set itself: kappa' contributes to kappa iff
    kappa' - kappa is a 0/1 vector — an O(|S|^2 d) sweep over tiny sets.
    """
    s = list(set(indices))
    coeffs: dict[tuple, int] = {}
    for kappa in s:
        c = 0
        for other in s:
            diff_sum = 0
            ok = True
            for a, b in zip(kappa, other):
                d = b - a
                if d == 0:
                    continue
                if d == 1:
                    diff_sum += 1
                else:
                    ok = False
                    break
            if ok:
                c += -1 if (diff_sum & 1) else 1
        if c != 0:
            coeffs[kappa] = c
    return coeffs
