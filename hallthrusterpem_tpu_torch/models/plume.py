"""Semi-empirical ion-current-density plume model (the JAX package's
``models/plume.py``): two-Gaussian beam plus charge-exchange background over a
91-point, 0-90 degree sweep, with the erfi normalisation in overflow-free form."""

from __future__ import annotations

import numpy as np
import torch

from hallthrusterpem_tpu_torch.constants import TORR_2_PA
from hallthrusterpem_tpu_torch.ops.integrate import simpson, simpson_weights
from hallthrusterpem_tpu_torch.ops.special import exp_neg_asq_re_erfi, exp_neg_sq_erfi

__all__ = ["current_density"]

_N_ANGLES = 91
_ALPHA_RAD = np.linspace(0.0, np.pi / 2, _N_ANGLES)
_SIMPSON_W = simpson_weights(_ALPHA_RAD)


def _gaussian_norm(alpha: torch.Tensor) -> torch.Tensor:
    """``(pi^{3/2}/2) alpha exp(-(alpha/2)^2) C(alpha)``: the inverse of the
    forward-hemisphere solid-angle integral of ``exp(-(theta/alpha)^2)``."""
    a = alpha / 2.0
    b = torch.full_like(alpha, np.pi) / (2.0 * alpha)  # a true divide, as in the JAX model
    combo = 2.0 * (exp_neg_sq_erfi(a) - exp_neg_asq_re_erfi(a, b))
    return float(np.pi ** 1.5 / 2.0) * alpha * combo


def current_density(inputs: dict, sweep_radius: float = 1.0) -> dict:
    """Ion current density ``j_ion`` (batch, 91) at one sweep radius [m], the
    divergence angle, the angle grid ``j_ion_coords`` [rad] and, when ``T`` is
    given, the divergence-corrected thrust ``T_c``.

    :param inputs: (batch,) tensors ``P_b`` (Torr), ``c0..c5``, ``sigma_cex`` (m^2),
        ``I_B0`` (A); optional ``T`` (N).
    """
    P_B = inputs["P_b"] * TORR_2_PA
    dt, dev = P_B.dtype, P_B.device
    batch = torch.broadcast_shapes(*(inputs[k].shape for k in (
        "P_b", "c0", "c1", "c2", "c3", "c4", "c5", "sigma_cex", "I_B0")))
    bc = lambda x: torch.broadcast_to(x.to(dt), batch)
    P_B = bc(P_B)
    c0, c1, c2, c3, c4, c5, sigma_cex, I_B0 = (bc(inputs[k]) for k in (
        "c0", "c1", "c2", "c3", "c4", "c5", "sigma_cex", "I_B0"))
    radius = float(sweep_radius)
    alpha_rad = torch.as_tensor(_ALPHA_RAD, dtype=dt, device=dev)

    n = c4 * P_B + c5  # facility neutral density (m^-3)
    alpha1 = torch.clamp(c2 * P_B + c3, max=np.pi / 2)  # main-beam divergence (rad)
    valid = alpha1 > 0
    alpha1_safe = torch.where(valid, alpha1, 0.1)  # keep the normalisation finite off-branch
    alpha2 = alpha1_safe / c1  # scattered-beam divergence (rad)

    A1 = (1 - c0) / _gaussian_norm(alpha1_safe)
    A2 = c0 / _gaussian_norm(alpha2)

    ex = lambda x: x[..., None]
    decay = torch.exp(-radius * ex(n) * ex(sigma_cex))  # (..., 1)
    j_cex = ex(I_B0) * (1 - decay) / (2 * np.pi * radius**2)
    base = ex(I_B0) * decay / radius**2
    j_beam = base * ex(A1) * torch.exp(-((alpha_rad / ex(alpha1_safe)) ** 2))
    j_scat = base * ex(A2) * torch.exp(-((alpha_rad / ex(alpha2)) ** 2))
    j_ion = j_beam + j_scat + j_cex  # (..., 91)

    # alpha1 <= 0 or any nonpositive density -> flat 1e-20 floor
    valid = valid & torch.all(j_ion > 0, dim=-1)
    j_ion = torch.where(valid[..., None], j_ion, 1e-20)

    # divergence angle: first moment of the flipped non-CEX profile
    w = torch.as_tensor(_SIMPSON_W, dtype=dt, device=dev)
    j_non_cex = torch.flip(j_beam + j_scat, dims=(-1,))
    den_igd = j_non_cex * torch.cos(alpha_rad)
    num_igd = den_igd * torch.sin(alpha_rad)
    cos_div = simpson(num_igd, weights=w) / simpson(den_igd, weights=w)
    cos_div = torch.where(torch.isfinite(cos_div), cos_div, torch.nan)
    div_angle = torch.arccos(torch.clamp(cos_div, -1.0, 1.0))

    out = {"j_ion": j_ion, "div_angle": div_angle}
    if inputs.get("T") is not None:
        out["T_c"] = inputs["T"] * cos_div
    out["j_ion_coords"] = torch.broadcast_to(alpha_rad, batch + (_N_ANGLES,))
    return out
