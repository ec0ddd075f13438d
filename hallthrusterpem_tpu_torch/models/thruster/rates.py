"""Electron-impact reaction rates (the JAX package's ``models/thruster/rates.py``):
closed-form log-polynomials in ln(Te) for the K-step kernel, and the same fits
resampled on a log-spaced Te grid for the lax solver's table lookup.

Coefficients are fitted in float64 numpy over the Te grid, exactly as the JAX
package does. Sources of the closed forms: Goebel & Katz, "Fundamentals of
Electric Propulsion", App. E (Xe single ionization and excitation); Lotz,
Z. Physik 216, 241 (1968), numerically Maxwellian-averaged (higher charge
states, Krypton).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hallthrusterpem_tpu_torch.constants import ELECTRON_MASS, FUNDAMENTAL_CHARGE

TE_MIN, TE_MAX, N_TABLE = 0.3, 150.0, 256
_LOG_TE = np.linspace(np.log10(TE_MIN), np.log10(TE_MAX), N_TABLE)
TE_GRID = 10.0**_LOG_TE
_K_FLOOR = 1e-32  # m^3/s

#: electron-neutral elastic momentum-transfer rate (m^3/s)
K_EN = {"Xenon": 2.5e-13, "Krypton": 1.8e-13, "Argon": 1.0e-13}

_EX_ENERGY = {"Xenon": 8.32, "Krypton": 9.915}
_IZ_ENERGY = {
    "Xenon": {1: 12.1298, 2: 20.975, 3: 31.05},
    "Krypton": {1: 13.9996, 2: 24.36, 3: 36.95},
}
_LOTZ_Q = {0: 6, 1: 5, 2: 4}


@dataclass(frozen=True)
class Reaction:
    """One ionization reaction z_from -> z_to with ``ln k = polyval(log_poly, ln Te)``."""

    z_from: int
    z_to: int
    energy_eV: float
    log_poly: tuple

    @property
    def table(self) -> tuple:
        """Rate coefficients (m^3/s) on TE_GRID, resampled from the fit."""
        return tuple(float(v) for v in _resample(np.asarray(self.log_poly)))


def fit_log_poly(table: np.ndarray, degree: int = 10) -> np.ndarray:
    """Fit ln(k) as a polynomial in ln(Te) over TE_GRID (floored at _K_FLOOR)."""
    x = np.log(TE_GRID)
    y = np.log(np.maximum(np.asarray(table, dtype=np.float64), _K_FLOOR))
    return np.polyfit(x, y, degree)


def _resample(coeffs: np.ndarray) -> np.ndarray:
    return np.exp(np.polyval(coeffs, np.log(TE_GRID)))


def _maxwellian_rate(sigma_fn, Te_eV: np.ndarray) -> np.ndarray:
    """<sigma(E) v> over a Maxwellian EEDF of temperature Te (eV)."""
    x = np.linspace(1e-4, 40.0, 4000)  # E/Te
    dx = x[1] - x[0]
    out = np.zeros_like(Te_eV)
    for i, Te in enumerate(Te_eV):
        integrand = sigma_fn(x * Te) * x * np.exp(-x)
        vbar = np.sqrt(8 * FUNDAMENTAL_CHARGE * Te / (np.pi * ELECTRON_MASS))
        out[i] = vbar * np.sum(integrand) * dx
    return out


def _lotz_sigma(P_eV: float, q: int, a: float = 4.0e-18, b: float = 0.6, c: float = 0.56):
    """Lotz empirical ionization cross-section (m^2)."""

    def sigma(E):
        E = np.asarray(E, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            s = a * q * np.log(np.maximum(E / P_eV, 1.0)) / (E * P_eV) * (
                1.0 - b * np.exp(-c * (E / P_eV - 1.0))
            )
        return np.where(E > P_eV, np.maximum(s, 0.0), 0.0)

    return sigma


def _goebel_katz_iz_rate(Te: np.ndarray) -> np.ndarray:
    """Xe single ionization: the Goebel & Katz fit below ~10 eV blended into a
    Lotz-averaged rate above ~18 eV."""
    vbar = np.sqrt(8 * FUNDAMENTAL_CHARGE * Te / (np.pi * ELECTRON_MASS))
    poly = 3.97 + 0.643 * Te - 0.0368 * Te**2
    gk = 1e-20 * np.maximum(poly, 0.0) * np.exp(-12.127 / Te) * vbar
    lotz = _maxwellian_rate(_lotz_sigma(12.1298, 6), Te)
    w = np.clip((Te - 10.0) / 8.0, 0.0, 1.0)
    return (1.0 - w) * gk + w * lotz


def build_reactions(propellant: str, ncharge: int) -> list[Reaction]:
    """All ionization reactions among charge states 0..ncharge, in kernel order."""
    E = _IZ_ENERGY[propellant]
    reactions = []
    for z_from in range(0, ncharge):
        for z_to in range(z_from + 1, ncharge + 1):
            cost = sum(E[z] for z in range(z_from + 1, z_to + 1))
            if z_from == 0 and z_to == 1 and propellant == "Xenon":
                raw = _goebel_katz_iz_rate(TE_GRID)
            else:
                # direct multi-ionization is suppressed ~5x per extra electron removed
                scale = 0.2 ** (z_to - z_from - 1)
                q = _LOTZ_Q.get(z_from, 3)
                raw = scale * _maxwellian_rate(
                    _lotz_sigma(cost, q, b=0.6 if z_from == 0 else 0.0), TE_GRID)
            coeffs = fit_log_poly(raw)
            reactions.append(Reaction(z_from, z_to, cost, tuple(float(c) for c in coeffs)))
    return reactions


def _goebel_katz_ex_rate(Te: np.ndarray) -> np.ndarray:
    """Xe effective excitation Maxwellian rate fit (Goebel & Katz App. E), m^3/s."""
    vbar = np.sqrt(8 * FUNDAMENTAL_CHARGE * Te / (np.pi * ELECTRON_MASS))
    return 1.93e-19 * np.exp(-11.6 / Te) / np.sqrt(Te) * vbar


def excitation_log_poly(propellant: str) -> tuple[np.ndarray, float]:
    """(log-poly coefficients, energy per event in eV) of the effective excitation."""
    if propellant == "Xenon":
        raw = _goebel_katz_ex_rate(TE_GRID)
        E = _EX_ENERGY["Xenon"]
    else:
        E = _EX_ENERGY.get(propellant, 10.0)
        raw = _maxwellian_rate(_lotz_sigma(E, 6), TE_GRID) * 2.0
    return fit_log_poly(raw), E


def dlnk_dlnTe_poly(log_poly) -> np.ndarray:
    """Coefficients of d(ln k)/d(ln Te), the exact derivative of the fit."""
    return np.polyder(np.asarray(log_poly, dtype=np.float64))


def excitation_table(propellant: str) -> tuple[np.ndarray, float]:
    """(rate table on TE_GRID, energy per event in eV) of the effective
    excitation, resampled from its log-poly fit."""
    coeffs, energy = excitation_log_poly(propellant)
    return _resample(coeffs), energy


def derivative_table(reaction_or_coeffs) -> np.ndarray:
    """``d(ln k)/d(ln Te)`` on TE_GRID (the table twin of :func:`dlnk_dlnTe_poly`)."""
    coeffs = getattr(reaction_or_coeffs, "log_poly", reaction_or_coeffs)
    return np.polyval(dlnk_dlnTe_poly(coeffs), np.log(TE_GRID))


def lookup_rate(table: torch.Tensor, Te: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a TE_GRID table at the electron temperature Te (eV):
    the grid is uniform in log10(Te), so the index is arithmetic; the position is
    truncated to an integer after the clip, as the JAX package casts it."""
    logt = torch.log10(torch.clamp(Te, TE_MIN, TE_MAX))
    pos = (logt - float(_LOG_TE[0])) / float(_LOG_TE[1] - _LOG_TE[0])
    idx = torch.clamp(pos.to(torch.int32), 0, N_TABLE - 2).long()
    frac = pos - idx
    return table[idx] * (1 - frac) + table[idx + 1] * frac
