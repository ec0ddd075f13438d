"""Closed-form fake thruster (the JAX package's ``models/fake_thruster.py``): a
cheap stand-in for the discharge solver with the thruster component's input and
output schema, for exercising the System layer."""

from __future__ import annotations

import torch

from hallthrusterpem_tpu_torch.constants import FUNDAMENTAL_CHARGE

__all__ = ["fake_thruster"]

_M_ION = 2.18e-25  # kg


def fake_thruster(inputs: dict, num_cells: int = 100, domain=(0.0, 0.08), **_unused) -> dict:
    """Analytic mock of the thruster component.

    :param inputs: ``V_a`` (V), ``V_cc`` (V), ``mdot_a`` (kg/s), ``a_1`` anomalous
        coefficient; tensors of one batch shape
    :returns: ``T``, ``I_B0``, ``I_d``, ``eta_c``, ``eta_m``, ``eta_v``, ``eta_a``,
        ``u_ion`` and ``u_ion_coords``
    """
    V_a = torch.as_tensor(inputs["V_a"])
    V_cc = torch.as_tensor(inputs.get("V_cc", 0.0 * V_a), device=V_a.device)
    mdot_a = torch.as_tensor(inputs["mdot_a"], device=V_a.device)
    a_1 = torch.as_tensor(inputs.get("a_1", 0.00625 + 0.0 * V_a), device=V_a.device)

    q = FUNDAMENTAL_CHARGE
    beam_current = (q / _M_ION) * mdot_a
    current_eff = 1 - a_1 * 2
    discharge_current = beam_current / current_eff
    v_exh = torch.sqrt(2 * q * (V_a - V_cc) / _M_ION)
    thrust = mdot_a * v_exh
    mass_eff = 1 - a_1 * 5
    voltage_eff = 1 - a_1 * 2
    anode_eff = 0.5 * thrust**2 / (mdot_a * V_a * discharge_current)

    z = torch.linspace(domain[0], domain[1], num_cells, dtype=thrust.dtype, device=thrust.device)
    u_ion = v_exh[..., None] / (1 + torch.exp(-100.0 * (z - 0.04)))
    return {
        "T": thrust,
        "I_B0": beam_current,
        "I_d": discharge_current,
        "eta_c": current_eff,
        "eta_m": mass_eff,
        "eta_v": voltage_eff,
        "eta_a": anode_eff,
        "u_ion": u_ion,
        "u_ion_coords": torch.broadcast_to(z, tuple(thrust.shape) + (num_cells,)),
    }
