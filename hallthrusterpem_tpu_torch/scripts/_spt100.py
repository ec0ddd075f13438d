"""What the SPT-100 physics studies share (the JAX package's ``scripts/anchors.py``
and the probes that copy from it): the published-data anchor table, the
nominal batch of the pem_v0 calibration, the LIF and Faraday data grouped by
background pressure, the u_ion rel-L2 against the LIF data and the input tree
of the batched ``run_simulation`` sweeps.

The data are the port's own copies in ``data/spt100/``; the System is the JSON
copy ``configs/pem_v0_SPT-100.json`` of ``scripts/pem_v0/pem_v0_SPT-100.yml``.
"""

from __future__ import annotations

import numpy as np
import torch

from hallthrusterpem_tpu_torch.data import SPT100_DATA_DIR

#: the pem_v0 SPT-100 System (the Thruster at full fidelity, 2e-3 s, cycle average)
CONFIG = "pem_v0_SPT-100.json"

# scalar anchors: operating condition -> data values + per-QoI relative tolerance.
# Diamant 2014 rows are interpolated to P_b = 1e-5 Torr; I_B0/eta bands are the
# published-estimate ranges quoted in docs/validation.md (round-3 table).
SCALAR_ANCHORS = [
    # round-5 ratcheted design-point table (T<=3%, I_d<=4%, I_B0<=10%)
    {"name": "diamant_300V_5.16mg_1e-5Torr", "P_b": 1.0e-5, "V_a": 300.0, "mdot_a": 5.16e-6,
     "data": {"T": 81.7e-3, "I_d": 4.60, "V_cc": 32.5, "I_B0": 3.6, "eta_c": 0.775, "eta_m": 0.90},
     "tol": {"T": 0.03, "I_d": 0.04, "V_cc": 0.05, "I_B0": 0.10, "eta_c": 0.12, "eta_m": 0.08}},
    {"name": "sankovic_250V_5.16mg", "P_b": 5.0e-6, "V_a": 250.0, "mdot_a": 5.16e-6,
     "data": {"T": 72.0e-3, "I_d": 4.60},
     "tol": {"T": 0.12, "I_d": 0.15}},
    {"name": "sankovic_400V_5.16mg", "P_b": 5.0e-6, "V_a": 400.0, "mdot_a": 5.16e-6,
     "data": {"T": 95.5e-3, "I_d": 4.47},
     "tol": {"T": 0.12, "I_d": 0.15}},
    {"name": "sankovic_300V_3.5mg", "P_b": 5.0e-6, "V_a": 300.0, "mdot_a": 3.5e-6,
     # off-design: the pem_v0 nominals are design-point calibration values; the
     # reference workflow recalibrates u_n/a_i per dataset (docs/validation.md)
     "data": {"T": 45.5e-3, "I_d": 3.05},
     "tol": {"T": 0.30, "I_d": 0.10}},
]

# u_ion(z) LIF anchors (MacDonald-Tenenbaum 2019): rel-L2 tolerance per pressure
UION_TOL = 0.16

# j_ion(theta) Faraday-probe anchors (Diamant 2014, r = 1 m sweeps at three
# background pressures): rel-L2 tolerance over the measured angles. The
# 2.9e-5 Torr sweep is model-form limited: the measured on-axis current rises
# with background pressure, while any fixed-divergence beam with CEX
# attenuation of this family attenuates.
JION_TOL = {1.7e-6: 0.20, 8.4e-6: 0.20, 2.9e-5: 0.50}

#: the design-point data of the probes' scalar errors (300 V, 5.16 mg/s, 1e-5 Torr)
DESIGN_POINT = SCALAR_ANCHORS[0]["data"]
#: the probes' names of the solver's averaged outputs
SOLVER_KEYS = {"T": "thrust", "I_d": "discharge_current", "I_B0": "ion_current"}

#: simulated seconds of the sweeps' solves and the start of their averaging window
DURATION = 2e-3
AVERAGE_START = 1e-3


def nominal_batch(system, conds: list[dict]) -> dict:
    """Every input at its pem_v0 nominal, operating columns from the conditions."""
    n = len(conds)
    batch = {}
    for v in system.inputs():
        if v.name in ("P_b", "V_a", "mdot_a"):
            batch[v.name] = np.array([c[v.name] for c in conds], dtype=np.float64)
        else:
            nom = v.nominal if v.nominal is not None else 0.5 * sum(v.get_domain())
            batch[v.name] = np.full(n, float(nom))
    return batch


def lif_rows() -> dict:
    """The u_ion LIF rows (MacDonald-Tenenbaum 2019) by background pressure:
    columns P_b, mdot, V_d, z from the anode [m], u [m/s], its uncertainty."""
    lif = np.genfromtxt(SPT100_DATA_DIR / "uion_macdonald2019.csv", delimiter=",", skip_header=1)
    return {float(pb): lif[lif[:, 0] == pb] for pb in np.unique(lif[:, 0])}


def jion_groups() -> dict:
    """The j_ion(theta) Faraday sweeps (Diamant 2014, r = 1 m) by background
    pressure: ``(theta [rad], j [A/m^2])``."""
    faraday = np.genfromtxt(SPT100_DATA_DIR / "jion_diamant2014.csv", delimiter=",", skip_header=1)
    groups = {}
    for pb in np.unique(faraday[:, 0]):
        rows = faraday[faraday[:, 0] == pb]
        groups[float(pb)] = (np.deg2rad(rows[:, 4]), rows[:, 5])
    return groups


def rel_l2(x_obs, y_obs, x_model, y_model) -> float:
    """Relative L2 error of the model profile, interpolated onto the data points."""
    y_int = np.interp(x_obs, x_model, y_model)
    return float(np.linalg.norm(y_int - y_obs) / np.linalg.norm(y_obs))


def design_errors(avg: dict, i: int) -> dict:
    """Relative errors of T, I_d and I_B0 in row ``i`` of the solver's averages
    against the design point."""
    return {q: float(np.asarray(avg[key])[i] / DESIGN_POINT[q] - 1) for q, key in SOLVER_KEYS.items()}


def sweep_tree(config: dict, anom_model: dict) -> dict:
    """The sweeps' input tree: SPT-100 at 300 V and 5.16 mg/s, 3 charge states,
    200 cells, plume and divergence correction, the cathode-line filter, the
    logistic pressure shift around ``anom_model``, adaptive dt over
    ``DURATION`` with 1000 saved currents and the cycle average from
    ``AVERAGE_START``; ``config`` adds or replaces config entries."""
    from hallthrusterpem_tpu_torch.utils import load_thruster

    return {
        "config": {
            "thruster": load_thruster("SPT-100"),
            "discharge_voltage": 300.0,
            "anode_mass_flow_rate": 5.16e-6,
            "cathode_Tev": 2.23,
            "ncharge": 3,
            "domain": (0.0, 0.08),
            "ion_wall_losses": True,
            "solve_plume": True,
            "apply_thrust_divergence_correction": True,
            "circuit": {"R": 0.5, "L": 0.0},
            **config,
            "anom_model": {"type": "LogisticPressureShift", **anom_model},
        },
        "simulation": {"adaptive": True, "dt": 1e-9, "min_dt": 1e-10, "max_dt": 1e-7,
                       "duration": DURATION, "num_save": 1000,
                       "grid": {"type": "EvenGrid", "num_cells": 200}},
        "postprocess": {"average_start_time": AVERAGE_START, "cycle_average": True},
    }


def to_numpy(tree):
    """The tensors of a nested dict or list as numpy arrays of their dtype."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
