"""Faddeeva w(z), Dawson F(x) and erfi in real-pair float arithmetic (the JAX
package's ``ops/special.py``): Weideman's (SIAM Rev. 36, 1994) rational
approximation, a fixed-degree polynomial in the Moebius-transformed argument."""

from __future__ import annotations

import numpy as np
import torch

_N = 36  # Weideman polynomial degree


def _weideman_coefficients(N: int) -> tuple[float, np.ndarray]:
    """(L, a[0..N-1]) for Weideman's Faddeeva approximation (float64)."""
    M = 2 * N
    M2 = 2 * M
    k = np.arange(-M + 1, M)
    L = np.sqrt(N / np.sqrt(2.0))
    theta = k * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-(t**2)) * (L**2 + t**2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / M2
    a = np.flipud(a[1 : N + 1])
    return float(L), a


_L, _A = _weideman_coefficients(_N)
_INV_SQRT_PI = float(1.0 / np.sqrt(np.pi))


def wofz_parts(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Re w(z), Im w(z))`` of the Faddeeva function at ``z = x + iy``, ``y >= 0``."""
    dr = _L + y
    di = -x
    d2 = dr * dr + di * di
    nr = _L - y
    ni = x
    zr = (nr * dr + ni * di) / d2
    zi = (ni * dr - nr * di) / d2
    pr = torch.zeros_like(zr)
    pi = torch.zeros_like(zi)
    for coeff in _A:
        pr, pi = pr * zr - pi * zi + float(coeff), pr * zi + pi * zr
    d2r = dr * dr - di * di
    d2i = 2.0 * dr * di
    d2n = d2r * d2r + d2i * d2i
    wr = 2.0 * (pr * d2r + pi * d2i) / d2n + _INV_SQRT_PI * dr / d2
    wi = 2.0 * (pi * d2r - pr * d2i) / d2n + _INV_SQRT_PI * (-di) / d2
    return wr, wi


def wofz(z) -> torch.Tensor:
    """Faddeeva function ``w(z) = exp(-z^2) erfc(-iz)`` for ``Im(z) >= 0``: complex
    in and out (a real tensor is taken as the real axis)."""
    z = torch.as_tensor(z)
    if not z.is_complex():
        z = torch.complex(z, torch.zeros_like(z))
    wr, wi = wofz_parts(z.real, z.imag)
    return torch.complex(wr, wi)


def dawson(x: torch.Tensor) -> torch.Tensor:
    """Dawson integral ``F(x) = exp(-x^2) int_0^x exp(t^2) dt`` for real ``x``."""
    ax = torch.abs(x)
    _, wi = wofz_parts(ax, torch.zeros_like(ax))
    return torch.sign(x) * float(np.sqrt(np.pi) / 2.0) * wi


def erfi(x: torch.Tensor) -> torch.Tensor:
    """Imaginary error function of a real argument."""
    return torch.exp(x**2) * float(2.0 / np.sqrt(np.pi)) * dawson(x)


def exp_neg_sq_erfi(a: torch.Tensor) -> torch.Tensor:
    """``exp(-a^2) * erfi(a)`` for real ``a``, overflow-free."""
    return float(2.0 / np.sqrt(np.pi)) * dawson(a)


def exp_neg_asq_re_erfi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``exp(-a^2) * Re[erfi(a + ib)] = e^{-b^2} (Im w cos 2ab + Re w sin 2ab)``
    for real ``a, b >= 0``, overflow-free."""
    wr, wi = wofz_parts(a, b)
    phase = 2.0 * a * b
    return torch.exp(-(b**2)) * (wi * torch.cos(phase) + wr * torch.sin(phase))
