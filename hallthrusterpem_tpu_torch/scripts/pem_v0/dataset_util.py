"""Experimental-dataset utilities of the pem_v0 analysis scripts (the JAX
package's ``scripts/pem_v0/dataset_util.py``): DataEntry records mapped onto the
PEM's input and output names, and field profiles reconstructed from SVD latents.
"""

from __future__ import annotations

import numpy as np
import torch

from hallthrusterpem_tpu_torch.core.dataset import to_numpy
from hallthrusterpem_tpu_torch.data import load_ht_datasets, spt100_datasets

#: PEM QoI name -> experimental data column
FIELD_COLS = {"u_ion": "ion velocity", "j_ion": "ion current density"}
SCALAR_COLS = {"V_cc": "cathode coupling voltage", "T": "thrust", "I_d": "discharge current"}


def resolve_data_files(data_args):
    """CSV paths from the --data argument ('spt100' = the bundled datasets)."""
    if len(data_args) == 1 and str(data_args[0]).lower() == "spt100":
        return spt100_datasets()
    return data_args


def load_experiment(data_args, qois):
    """(ops dict-of-arrays, scalar obs dict, scalar 1-sigma dict, field specs dict).

    ``fields[qoi]`` is a list aligned with the operating conditions: ``None``
    where that condition has no field measurement, else a dict with ``coords``
    (z [m] or theta [rad]), ``vals`` and 1-sigma ``stds``.
    """
    entries = load_ht_datasets(resolve_data_files(data_args))
    ops = {
        "P_b": np.array([e.operating_condition["background pressure"] for e in entries]),
        "V_a": np.array([e.operating_condition["discharge voltage"] for e in entries]),
        "mdot_a": np.array([e.operating_condition["anode mass flow rate"] for e in entries]),
    }
    obs, sig = {}, {}
    for qoi, col in SCALAR_COLS.items():
        if qoi not in qois:
            continue
        obs[qoi] = np.asarray(
            [np.ravel(e.data[col].val)[0] if col in e.data else np.nan for e in entries], dtype=float)
        sig[qoi] = np.asarray(
            [np.ravel(e.data[col].std)[0] if col in e.data else np.nan for e in entries], dtype=float)
    fields = {}
    for qoi, col in FIELD_COLS.items():
        if qoi not in qois:
            continue
        specs = []
        for e in entries:
            if col not in e.data:
                specs.append(None)
                continue
            f = e.data[col]
            cname = "z" if qoi == "u_ion" else "theta"
            specs.append({
                "coords": np.asarray(f.coords[cname], dtype=float),
                "vals": np.asarray(f.val, dtype=float).ravel(),
                "stds": np.asarray(f.std, dtype=float).ravel(),
            })
        if any(s is not None for s in specs):
            fields[qoi] = specs
    return ops, obs, sig, fields


def field_profiles(system, pred, qoi):
    """Physical-space profiles ``(values, grid)`` of a field QoI from a
    ``predict`` result, as host numpy arrays.

    The true-model path returns full profiles and ``{qoi}_coords``; the
    surrogate path returns SVD latent coefficients, reconstructed here through
    the output variable's compression map (``Compression.reconstruct``) in
    float32 on the host, as the JAX package reconstructs them.
    """
    vals = np.asarray(to_numpy(pred[qoi]), dtype=float)
    ckey = f"{qoi}_coords"
    if ckey in pred:
        grid = np.asarray(to_numpy(pred[ckey]), dtype=float)
        if grid.ndim == 1:
            grid = np.broadcast_to(grid, vals.shape)
        return vals, grid
    var = next(v for v in system.outputs() if v.name == qoi)
    if var.compression is None or var.compression.coords is None:
        raise ValueError(f"{qoi}: surrogate returned {vals.shape[-1]} columns but the variable "
                         "has no compression map to reconstruct a profile from")
    rec = var.compression.reconstruct(torch.as_tensor(vals, dtype=torch.float32))
    prof = to_numpy(var.denormalize(rec)).astype(float)
    grid = np.asarray(var.compression.coords, dtype=float).reshape(-1)[: prof.shape[-1]]
    return prof, np.broadcast_to(grid, prof.shape)
