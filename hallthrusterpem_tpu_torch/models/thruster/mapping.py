"""PEM variable <-> solver input-tree mapping (the JAX package's
``models/thruster/mapping.py``).

``PEM_TO_JULIA`` maps each PEM shorthand name to its path in the
HallThruster.jl-format input/output tree: the public variable contract of the
thruster component. Values in the tree may be scalars, numpy arrays or tensors.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from hallthrusterpem_tpu_torch.constants import (
    AVOGADRO_CONSTANT,
    FUNDAMENTAL_CHARGE,
    MOLECULAR_WEIGHTS,
)

__all__ = ["PEM_TO_JULIA", "convert_to_config", "convert_to_pem", "default_model_fidelity",
           "format_input_tree"]

PEM_TO_JULIA: dict = {
    "P_b": ["config", "background_pressure_Torr"],
    "mdot_a": ["config", "anode_mass_flow_rate"],
    "V_cc": ["config", "cathode_coupling_voltage"],
    "u_n": ["config", "neutral_velocity"],
    "T_e": ["config", "cathode_Tev"],
    "l_t": ["config", "transition_length"],
    "V_a": ["config", "discharge_voltage"],
    "dz": ["config", "anom_model", "dz"],
    "z0": ["config", "anom_model", "z0"],
    "p0": ["config", "anom_model", "pstar"],
    "alpha": ["config", "anom_model", "alpha"],
    "a_1": ["config", "anom_model", "model", "c1"],
    "a_2": ["config", "anom_model", "model", "c2"],
    "anom_min": ["config", "anom_model", "model", "hall_min"],
    "anom_max": ["config", "anom_model", "model", "hall_max"],
    "anom_center": ["config", "anom_model", "model", "center"],
    "anom_width": ["config", "anom_model", "model", "width"],
    "anom_scale": ["config", "anom_model", "model", "anom_scale"],
    "anom_barrier_scale": ["config", "anom_model", "model", "barrier_scale"],
    "anom_shift_length": ["config", "anom_model", "shift_length"],
    "f_n": ["config", "neutral_ingestion_multiplier"],
    # discharge-circuit filter (see config._DEFAULTS)
    "R_c": ["config", "circuit", "R"],
    "L_c": ["config", "circuit", "L"],
    "c_w": ["config", "wall_loss_model", "loss_scale"],
    "ncharge": ["config", "ncharge"],
    "B_hat": ["config", "magnetic_field_scale"],
    "num_cells": ["simulation", "grid", "num_cells"],
    "dt": ["simulation", "dt"],
    "I_B0": ["output", "average", "ion_current"],
    "I_d": ["output", "average", "discharge_current"],
    "T": ["output", "average", "thrust"],
    "eta_c": ["output", "average", "current_eff"],
    "eta_m": ["output", "average", "mass_eff"],
    "eta_v": ["output", "average", "voltage_eff"],
    "eta_a": ["output", "average", "anode_eff"],
    "u_ion": ["output", "average", "ui", 0],
    "u_ion_coords": ["output", "average", "z"],
    # simulation.num_save discharge-current time series (breathing diagnostics)
    "discharge_current_trace": ["output", "average", "discharge_current_trace"],
    "trace_times": ["output", "average", "trace_times"],
}


def convert_to_config(pem_data: dict, tree: dict, pem_to_julia: dict) -> None:
    """Set ``tree[path...] = value`` for every PEM variable, creating the
    intermediate dicts and lists as needed. Values may be scalars or batches."""
    for pem_key, value in pem_data.items():
        if pem_key not in pem_to_julia:
            raise KeyError(f"Cannot convert PEM data variable {pem_key}: not in the conversion map")
        path = pem_to_julia[pem_key]
        pointer = tree
        for i, key in enumerate(path[:-1]):
            next_is_str = isinstance(path[i + 1], str)
            if isinstance(pointer, dict):
                if not pointer.get(key):
                    pointer[key] = {} if next_is_str else []
            elif isinstance(pointer, list) and len(pointer) <= key:
                pointer.extend({} if next_is_str else [] for _ in range(key - len(pointer) + 1))
            pointer = pointer[key]
        last = path[-1]
        if isinstance(pointer, list) and isinstance(last, int) and len(pointer) <= last:
            pointer.extend(None for _ in range(last - len(pointer) + 1))
        pointer[last] = value


def convert_to_pem(tree: dict, pem_to_julia: dict) -> dict:
    """Every ``output``-rooted mapped entry present in an output tree."""
    pem_data = {}
    for pem_key, path in pem_to_julia.items():
        if path[0] != "output":
            continue
        pointer = tree
        found = True
        for key in path:
            try:
                pointer = pointer[key]
            except (KeyError, IndexError, TypeError):
                found = False
                break
        if found:
            pem_data[pem_key] = pointer
    return pem_data


def _extreme(value, largest: bool) -> float:
    """Largest or smallest element of a scalar, array or tensor, as a float,
    NaN elements skipped (NaN when all are): a failed or padded row must not
    set the whole batch's grid or time step."""
    t = torch.as_tensor(value, dtype=torch.float64).reshape(-1)
    t = t[~torch.isnan(t)]
    if t.numel() == 0:
        return float("nan")
    return float(t.max() if largest else t.min())


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
    anode_pot = _extreme(anode_pot, largest=True)
    cathode_pot = _extreme(cathode_pot, largest=False)
    u = np.sqrt(2 * ncharge * FUNDAMENTAL_CHARGE * max(anode_pot - cathode_pot, 1.0) / mi)
    return {"num_cells": num_cells, "ncharge": ncharge, "dt": float(cfl * dx / u)}


def format_input_tree(
    thruster_inputs: dict,
    pem_to_julia: dict,
    thruster="SPT-100",
    config: dict | None = None,
    simulation: dict | None = None,
    postprocess: dict | None = None,
    model_fidelity: tuple | None = (2, 2),
    fidelity_function: Callable | None = None,
) -> dict:
    """The full input tree: the given sections, the device (a packaged device name
    or directory is loaded with :func:`~hallthrusterpem_tpu_torch.utils.load_thruster`),
    the PEM inputs at their mapped paths, the fidelity overrides, and the
    anomalous-model coefficient special cases."""
    from hallthrusterpem_tpu_torch.utils import load_thruster

    tree = {
        "config": copy.deepcopy(config) if config else {},
        "simulation": copy.deepcopy(simulation) if simulation else {},
        "postprocess": copy.deepcopy(postprocess) if postprocess else {},
    }
    if isinstance(thruster, str) or hasattr(thruster, "__fspath__"):
        thruster = load_thruster(thruster)
    if thruster is not None:
        tree["config"]["thruster"] = thruster

    duration = tree["simulation"].get("duration", 1e-3)
    tree["postprocess"].setdefault("average_start_time", 0.5 * duration)

    convert_to_config(thruster_inputs, tree, pem_to_julia)

    if model_fidelity is not None:
        fidelity_function = fidelity_function or default_model_fidelity
        convert_to_config(fidelity_function(tuple(model_fidelity), tree), tree, pem_to_julia)

    # the PEM's a_2 is a ratio (c2 = a_2 * c1); GaussianBohm's anom_max is a ratio on
    # hall_min. Follow the actual nesting, not the "type" tag: the path map writes
    # a_2 at config.anom_model.model.c2 even without an explicit anom_model config.
    anom = tree["config"].get("anom_model")
    if anom:
        inner = anom["model"] if isinstance(anom.get("model"), dict) else anom
        if inner.get("type", "TwoZoneBohm") == "TwoZoneBohm":
            if thruster_inputs.get("a_2") is not None:
                inner["c2"] = inner["c2"] * inner.get("c1", 0.00625)
        elif inner.get("type") == "GaussianBohm":
            if thruster_inputs.get("anom_max") is not None:
                inner["hall_max"] = inner["hall_max"] * inner.get("hall_min", 0.00625)
    return tree
