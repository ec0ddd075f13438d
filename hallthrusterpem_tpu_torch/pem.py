"""Coupled PEM: cathode -> 1-D discharge solver -> plume (the JAX package's
``pem.py`` on its K-step kernel branch).

Stage 1 (:func:`_coupled_pre`) runs the cathode model and assembles the solver
parameters; stage 2 is :func:`~.models.thruster.fused_step.simulate_batch_multi`,
the K-step time loop around the hand-written CUDA kernel; stage 3
(:func:`_coupled_post`) runs the plume model and assembles the outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from hallthrusterpem_tpu_torch.models.cathode import cathode_coupling
from hallthrusterpem_tpu_torch.models.plume import current_density
from hallthrusterpem_tpu_torch.models.thruster import _load_bfield
from hallthrusterpem_tpu_torch.models.thruster.config import Geometry, SolverConfig, make_params
from hallthrusterpem_tpu_torch.models.thruster.fused_step import simulate_batch_multi
from hallthrusterpem_tpu_torch.models.thruster.mapping import default_model_fidelity
from hallthrusterpem_tpu_torch.utils import load_thruster, resolve_device

__all__ = ["CoupledPEM", "default_coupled_inputs"]

#: nominal pem_v0 SPT-100 input set (the JAX package's ``pem._NOMINALS``)
_NOMINALS = {
    "P_b": 1e-5, "V_a": 300.0, "mdot_a": 5e-6,
    "T_e": 1.32721, "V_vac": 31.61135, "Pstar": 34.63406e-6, "P_T": 10.19193e-6,
    "u_n": 145.40052, "l_t": 1.87915e-3, "a_1": 0.00561226, "a_2": 41.1918,
    "dz": 0.2, "z0": -0.03104, "p0": 56.86006e-6,
    "c0": 0.15936, "c1": 0.87594, "c2": 0.48206, "c3": 0.35883,
    "c4": 3.1186e20, "c5": 1.2786e17, "sigma_cex": 55.0e-20,
}


def default_coupled_inputs(batch: int, generator: Optional[torch.Generator] = None,
                           spread: float = 0.1, device=None) -> dict:
    """A (batch,) float32 input dict drawn uniformly within ``±spread`` of the
    pem_v0 nominal operating point. Numbers are drawn on the CPU from
    ``generator`` (seed 0 when omitted) and then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    out = {}
    for name, nom in _NOMINALS.items():
        lo, hi = sorted((nom * (1 - spread), nom * (1 + spread)))
        u = torch.rand(batch, generator=generator, dtype=torch.float64)
        out[name] = (lo + (hi - lo) * u).to(device=device, dtype=torch.float32)
    return out


class CoupledPEM(torch.nn.Module):
    """Coupled PEM for a fixed device and solver configuration.

    >>> pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2))
    >>> outputs = pem(inputs)   # inputs: dict of (batch,) tensors on pem.device
    """

    def __init__(
        self,
        thruster="SPT-100",
        model_fidelity: tuple = (2, 2),
        sweep_radius: float = 1.0,
        config: Optional[dict] = None,
        simulation: Optional[dict] = None,
        anom_model: str = "TwoZoneBohm",
        pressure_shift: str = "LogisticPressureShift",
        duration: float = 1e-3,
        average_start_time: Optional[float] = None,
        solve_plume: bool = True,
        apply_thrust_divergence_correction: bool = True,
        device=None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        dev_cfg = load_thruster(thruster) if isinstance(thruster, str) else thruster
        geom = dev_cfg.get("geometry", {})
        config = config or {}
        fid = default_model_fidelity(tuple(model_fidelity), {"config": config})
        sim = dict(simulation or {})
        duration = float(sim.get("duration", duration))
        self.cfg = SolverConfig(
            num_cells=int(sim.get("num_cells", fid["num_cells"])),
            ncharge=int(config.get("ncharge", fid["ncharge"])),
            dt=float(sim.get("dt", fid["dt"])),
            duration=duration,
            average_start_time=float(
                average_start_time if average_start_time is not None else 0.5 * duration),
            geometry=Geometry(
                channel_length=float(geom.get("channel_length", 0.025)),
                inner_radius=float(geom.get("inner_radius", 0.0345)),
                outer_radius=float(geom.get("outer_radius", 0.05)),
            ),
            anom_model=anom_model,
            pressure_shift=pressure_shift,
            solve_plume=bool(config.get("solve_plume", solve_plume)),
            apply_thrust_divergence_correction=bool(
                config.get("apply_thrust_divergence_correction", apply_thrust_divergence_correction)),
        )
        self.register_buffer("base_B", torch.as_tensor(
            _load_bfield(dev_cfg, self.cfg), dtype=torch.float32, device=self.device))
        self.sweep_radius = sweep_radius

    def forward(self, inputs: dict, chunk_steps: Optional[int] = None) -> dict:
        """Evaluate the coupled PEM on a dict of (batch,) tensors.

        ``chunk_steps`` is the JAX package's argument and has no effect here: the
        K-step kernel path launches the time loop K steps at a time, and the JAX
        package's kernel branch ignores it as well."""
        inputs = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                  for k, v in inputs.items()}
        solver_params, v_cc = _coupled_pre(inputs, self.cfg)
        sol = simulate_batch_multi(solver_params, self.base_B, self.cfg)
        return _coupled_post(inputs, v_cc, sol, self.sweep_radius, self.cfg)

    def example_inputs(self, batch: int = 16, generator: Optional[torch.Generator] = None) -> dict:
        """:func:`default_coupled_inputs` of ``batch`` samples on the module's device."""
        return default_coupled_inputs(batch, generator, device=self.device)


def _coupled_pre(inputs: dict, cfg: SolverConfig):
    """Stage 1: cathode model and solver parameter assembly."""
    x = inputs
    v_cc = cathode_coupling(
        {"P_b": x["P_b"], "V_a": x["V_a"], "T_e": x["T_e"],
         "V_vac": x["V_vac"], "Pstar": x["Pstar"], "P_T": x["P_T"]})["V_cc"]
    solver_params = make_params(
        {
            "V_d": x["V_a"], "V_cc": v_cc, "mdot_a": x["mdot_a"], "P_b": x["P_b"],
            "T_e_cath": x["T_e"], "u_n": x["u_n"], "l_t": x["l_t"],
            "a1": x["a_1"], "a2": x["a_1"] * x["a_2"],  # PEM a_2 is a ratio
            "shift_dz": x["dz"], "shift_z0": x["z0"], "shift_pstar": x["p0"],
        },
        batch_shape=tuple(x["V_a"].shape),
    )
    return solver_params, v_cc


def _coupled_post(inputs: dict, v_cc, sol: dict, sweep_radius, cfg: SolverConfig) -> dict:
    """Stage 3: plume model and output assembly from the solver results."""
    x = inputs
    plume = current_density(
        {"P_b": x["P_b"], "c0": x["c0"], "c1": x["c1"], "c2": x["c2"], "c3": x["c3"],
         "c4": x["c4"], "c5": x["c5"], "sigma_cex": x["sigma_cex"],
         "I_B0": sol["ion_current"], "T": sol["thrust"]},
        sweep_radius=sweep_radius,
    )
    return {
        "V_cc": v_cc,
        "T": sol["thrust"],
        "I_d": sol["discharge_current"],
        "I_B0": sol["ion_current"],
        "eta_c": sol["current_eff"],
        "eta_m": sol["mass_eff"],
        "eta_v": sol["voltage_eff"],
        "eta_a": sol["anode_eff"],
        "u_ion": sol["ui"][:, 0, :],
        "u_ion_coords": sol["z"],
        "j_ion": plume["j_ion"],
        "j_ion_coords": plume["j_ion_coords"],
        "div_angle": plume["div_angle"],
        "T_c": plume["T_c"],
        "I_d_std": sol["discharge_current_std"],
    }
