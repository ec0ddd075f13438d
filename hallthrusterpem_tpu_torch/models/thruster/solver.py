"""Static-in-time profile helpers of the discharge solver (the JAX package's
``models/thruster/solver.py``): the anomalous-transport profile with its
pressure shift, and the electron-wall energy-loss rate."""

from __future__ import annotations

import numpy as np
import torch

from hallthrusterpem_tpu_torch.constants import ELECTRON_MASS, FUNDAMENTAL_CHARGE
from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig

_E = FUNDAMENTAL_CHARGE
_ME = ELECTRON_MASS


def _pressure_shift_m(p: dict, cfg: SolverConfig, z_ch: float):
    """Downstream shift [m] of the anomalous profile against background pressure:
    ``(z0 + dz (1 - sigmoid(alpha (P/P* - 1)))) L_ch`` (LogisticPressureShift)."""
    if cfg.pressure_shift == "none":
        return 0.0
    sig = torch.sigmoid(p["shift_alpha"] * (p["P_b"] / p["shift_pstar"] - 1.0))
    if cfg.pressure_shift == "SimpleLogisticShift":
        return p["shift_dz"] * (1.0 - sig) * z_ch
    return (p["shift_z0"] + p["shift_dz"] * (1.0 - sig)) * z_ch


def wall_energy_loss_rate(Te, ne, in_channel, c_w, cfg: SolverConfig, lnTe=None, rs_te=None):
    """Electron-wall energy-loss frequency nu_eps [1/s]: the volumetric loss is
    ``nu_eps * (3/2 n Te)``. "sheath" is a BN secondary-emission wall sheath;
    "landmark" is ``1e7 exp(-20/Te)`` inside the channel."""
    if cfg.wall_loss_type == "sheath":
        if lnTe is not None:
            gamma = torch.clamp(1.4 * torch.exp(0.576 * (lnTe - float(np.log(cfg.see_crossover_eV)))),
                                max=cfg.see_gamma_max)
        else:
            gamma = torch.clamp(1.4 * (Te * (1.0 / cfg.see_crossover_eV)) ** 0.576,
                                max=cfg.see_gamma_max)
        one_m_g = 1.0 - gamma
        phi_w_over_te = torch.clamp(
            torch.log(one_m_g * float(np.sqrt(cfg.mi / (2 * np.pi * _ME)))), min=0.0)
        coef = float(cfg.wall_energy_scale * 0.6 * np.sqrt(_E / cfg.mi)
                     / cfg.geometry.channel_gap / 1.5)
        sqrt_te = (Te * rs_te) if rs_te is not None else torch.sqrt(Te)
        return (coef * c_w) * sqrt_te / one_m_g * (2.0 + phi_w_over_te) * in_channel
    return (cfg.wall_energy_scale * c_w * 1e7 * torch.exp(torch.full_like(Te, -20.0) / Te)
            * in_channel)


def anomalous_profile(p: dict, z: torch.Tensor, cfg: SolverConfig) -> torch.Tensor:
    """Dimensionless anomalous collision coefficient alpha(z), (batch, NC) for
    (batch,) parameters and the (NC,) cell centres: TwoZoneBohm (with the
    transport-barrier well and near-anode plateau) or GaussianBohm."""
    col = lambda k: p[k][:, None]
    z_ch = cfg.geometry.channel_length
    shift = _pressure_shift_m(p, cfg, z_ch)
    shift = shift[:, None] if isinstance(shift, torch.Tensor) else shift
    if cfg.anom_model == "GaussianBohm":
        zc = col("center") + shift
        return col("hall_max") + (col("hall_min") - col("hall_max")) * torch.exp(
            -0.5 * ((z - zc) / torch.clamp(col("width"), min=1e-4)) ** 2)
    z_tr = z_ch + shift
    w = 0.5 * (1.0 + torch.tanh(2.0 * (z - z_tr) / torch.clamp(col("l_t"), min=1e-4)))
    alpha = col("a1") + (col("a2") - col("a1")) * w
    if cfg.anom_barrier_width > 0:
        # transport-barrier well at the (shifted) field peak, pulling the profile
        # toward the floor a1 (1 - depth); per-sample width when anom_width > 0
        aw = col("anom_width")
        width = torch.where(aw > 0, aw, cfg.anom_barrier_width)
        g = torch.exp(-0.5 * ((z - z_tr) / width) ** 2)
        floor = col("a1") * (1.0 - torch.clamp(col("anom_depth"), 0.0, 0.98))
        alpha = alpha + g * (floor - alpha)
    if cfg.anode_alpha > 0:
        # near-anode conductive plateau with a logistic roll-off
        edge = cfg.anode_edge_frac * z_ch + shift
        roll = 0.5 * (1.0 - torch.tanh((z - edge) / cfg.anode_edge_width))
        alpha = alpha + cfg.anode_alpha * roll
    return alpha
