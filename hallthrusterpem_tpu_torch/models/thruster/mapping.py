"""Model-fidelity mapping (``default_model_fidelity`` of the JAX package's
``models/thruster/mapping.py``)."""

from __future__ import annotations

import numpy as np

from hallthrusterpem_tpu_torch.constants import (
    AVOGADRO_CONSTANT,
    FUNDAMENTAL_CHARGE,
    MOLECULAR_WEIGHTS,
)


def default_model_fidelity(model_fidelity: tuple, json_config: dict, cfl: float = 0.2) -> dict:
    """Model-fidelity tuple -> ``{num_cells, ncharge, dt}``: ``ncells = 50 (alpha0+2)``,
    ``ncharge = alpha1 + 1``, ``dt`` from a CFL bound on the fastest ion."""
    if model_fidelity == ():
        model_fidelity = (2, 2)
    num_cells = 50 * (model_fidelity[0] + 2)
    ncharge = model_fidelity[1] + 1

    config = json_config.get("config", {})
    domain = config.get("domain", [0, 0.08])
    anode_pot = config.get("discharge_voltage", 300)
    cathode_pot = config.get("cathode_coupling_voltage", 0)
    propellant = config.get("propellant", "Xenon")
    if propellant not in MOLECULAR_WEIGHTS:
        propellant = "Xenon"

    mi = MOLECULAR_WEIGHTS[propellant] / AVOGADRO_CONSTANT / 1000
    dx = float(domain[1]) / (num_cells + 1)
    anode_pot = float(np.max(np.asarray(anode_pot)))
    cathode_pot = float(np.min(np.asarray(cathode_pot)))
    u = np.sqrt(2 * ncharge * FUNDAMENTAL_CHARGE * max(anode_pot - cathode_pot, 1.0) / mi)
    return {"num_cells": num_cells, "ncharge": ncharge, "dt": float(cfl * dx / u)}
