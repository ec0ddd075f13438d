"""Static configuration of the 1-D Hall discharge solver (the JAX package's
``models/thruster/config.py``).

Everything that fixes shapes or control flow lives in the frozen
:class:`SolverConfig`; everything that varies per sample is a (batch,) tensor in
the params dict built by :func:`make_params`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hallthrusterpem_tpu_torch.constants import BOLTZMANN_CONSTANT, TORR_2_PA, atomic_mass_kg

__all__ = ["Geometry", "SolverConfig", "make_params", "PARAM_NAMES",
           "background_neutral_ingestion_flux"]


@dataclass(frozen=True)
class Geometry:
    channel_length: float = 0.025  # m
    inner_radius: float = 0.0345  # m
    outer_radius: float = 0.05  # m

    @property
    def channel_area(self) -> float:
        return float(np.pi * (self.outer_radius**2 - self.inner_radius**2))

    @property
    def channel_gap(self) -> float:
        return self.outer_radius - self.inner_radius


@dataclass(frozen=True)
class SolverConfig:
    """Hashable static solver configuration; the fields, defaults and meaning
    are those of the JAX package's ``SolverConfig``, where each is documented."""

    num_cells: int = 100
    ncharge: int = 1
    domain: tuple[float, float] = (0.0, 0.08)
    geometry: Geometry = Geometry()
    propellant: str = "Xenon"
    dt: float = 5e-9
    duration: float = 1e-3
    average_start_time: float = 5e-4
    anom_model: str = "TwoZoneBohm"  # or "GaussianBohm"
    pressure_shift: str = "none"  # or "LogisticPressureShift" | "SimpleLogisticShift"
    ion_wall_losses: bool = True
    electron_wall_losses: bool = True
    wall_momentum_scale: float = 0.0
    wall_energy_scale: float = 1.0
    wall_loss_type: str = "sheath"  # or "landmark"
    see_crossover_eV: float = 45.0
    see_gamma_max: float = 0.983
    apply_thrust_divergence_correction: bool = False
    solve_plume: bool = False
    neutral_temp_K: float = 500.0
    ion_temp_K: float = 1000.0
    background_temp_K: float = 150.0
    ne_floor: float = 1e12
    Te_min: float = 0.5
    Te_max: float = 150.0
    anode_Te: float = 2.0
    mdot_bohm_fraction: float = 1.0
    reconstruct: bool = True
    anode_sheath: bool = True
    implicit_inelastic: bool = True
    num_save: int = 0
    neutral_groups: int = 1
    fast_neutral_fraction: float = 0.25
    fast_neutral_ratio: float = 2.2
    slow_neutral_ratio: float = 0.6
    anom_barrier_width: float = 2.5e-3
    anode_alpha: float = 0.03
    anode_edge_frac: float = 0.55
    anode_edge_width: float = 1.5e-3
    wall_recycling: float = 0.78
    dtype: str = "float32"

    @property
    def nc(self) -> int:
        """Total cells including the two ghost/boundary cells."""
        return self.num_cells + 2

    @property
    def dz(self) -> float:
        return (self.domain[1] - self.domain[0]) / self.num_cells

    @property
    def mi(self) -> float:
        return atomic_mass_kg(self.propellant)

    @property
    def num_steps(self) -> int:
        return max(1, int(round(self.duration / self.dt)))

    @property
    def avg_start_step(self) -> int:
        return min(self.num_steps - 1, int(round(self.average_start_time / self.dt)))

    def cell_centers(self) -> np.ndarray:
        """NC cell-centre coordinates with boundary points at the domain edges."""
        z0, z1 = self.domain
        interior = z0 + (np.arange(self.num_cells) + 0.5) * self.dz
        return np.concatenate([[z0], interior, [z1]])


#: per-sample parameter names (each becomes a (batch,) tensor)
PARAM_NAMES = (
    "V_d", "V_cc", "mdot_a", "P_b", "T_e_cath", "u_n", "l_t", "a1", "a2",
    "hall_min", "hall_max", "center", "width", "shift_dz", "shift_z0", "shift_pstar",
    "shift_alpha", "anom_depth", "anom_width", "f_n", "c_w", "B_hat", "tan_div",
    "circuit_R", "circuit_L",
)

_DEFAULTS = {
    "V_d": 300.0, "V_cc": 0.0, "mdot_a": 5e-6, "P_b": 0.0, "T_e_cath": 3.0,
    "u_n": 300.0, "l_t": 0.003, "a1": 0.00625, "a2": 0.0625, "hall_min": 0.00625,
    "hall_max": 0.0625, "center": 0.025, "width": 0.005, "shift_dz": 0.2,
    "shift_z0": 0.0, "shift_pstar": 45.0e-6, "shift_alpha": 15.0, "anom_depth": 0.904,
    "anom_width": 0.0, "f_n": 1.0, "c_w": 1.0, "B_hat": 1.0, "tan_div": 0.1835,
    "circuit_R": 0.0, "circuit_L": 0.0,
}


def make_params(overrides: Optional[dict] = None, batch_shape: tuple = (),
                device=None) -> dict:
    """The full per-sample float32 parameter dict, defaults broadcast.

    :param overrides: name -> scalar or (batch,) tensor/array
    :param batch_shape: common batch shape (inferred from overrides if empty)
    """
    overrides = dict(overrides or {})
    unknown = set(overrides) - set(PARAM_NAMES)
    if unknown:
        raise KeyError(f"Unknown solver parameters: {sorted(unknown)}")
    if not batch_shape:
        batch_shape = tuple(np.broadcast_shapes(*(tuple(np.shape(v)) for v in overrides.values())))
    if device is None:
        device = next((v.device for v in overrides.values() if isinstance(v, torch.Tensor)), None)
    return {name: torch.broadcast_to(
                torch.as_tensor(overrides.get(name, _DEFAULTS[name]), dtype=torch.float32,
                                device=device), tuple(batch_shape))
            for name in PARAM_NAMES}


def background_neutral_ingestion_flux(P_b_torr: torch.Tensor, f_n: torch.Tensor,
                                      cfg: SolverConfig) -> torch.Tensor:
    """Effusion mass flux [kg/s] of facility background neutrals through the exit
    plane, added to the anode flow."""
    P = P_b_torr * TORR_2_PA
    # the square root in the inputs' precision, as the JAX model takes it: of the
    # float32-rounded argument for float32 inputs
    arg = cfg.mi / (2 * math.pi * BOLTZMANN_CONSTANT * cfg.background_temp_K)
    root = math.sqrt(arg) if P_b_torr.dtype == torch.float64 else float(np.sqrt(np.float32(arg)))
    flux = P * root
    return f_n * flux * cfg.geometry.channel_area
