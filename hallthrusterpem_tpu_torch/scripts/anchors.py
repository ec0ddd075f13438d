"""Published-data anchor regression: the pem_v0 nominal model against the
bundled SPT-100 datasets (the JAX package's ``scripts/anchors.py``).

Runs the unmodified pem_v0 nominal calibration through the full System
(Cathode -> Thruster -> Plume; the Thruster at full fidelity, 2e-3 s, cycle
average) over the 10 anchored operating conditions in one batch, through the
K-step kernel on the card, and writes the artifact: model against data for T,
I_d, I_B0, eta_c, eta_m, V_cc at 4 scalar conditions, u_ion(z) rel-L2 against
the LIF reconstructions at 3 pressures and j_ion(theta) rel-L2 against the
Faraday sweeps at 3 pressures, each beside its stated tolerance. The artifact
records the platform, the device's name and its power limit.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.anchors [-o runs/h100/anchors.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from datetime import date
from pathlib import Path

import numpy as np
import torch

from hallthrusterpem_tpu_torch.scripts._spt100 import (
    CONFIG,
    JION_TOL,
    SCALAR_ANCHORS,
    UION_TOL,
    jion_groups,
    lif_rows,
    nominal_batch,
    rel_l2,
    to_numpy,
)


def device_record(device: torch.device) -> dict:
    """The platform (``"gpu"`` or ``"cpu"``), the device's name and, for a card,
    its power limit as ``nvidia-smi`` reads it (None where it cannot be read)."""
    if device.type != "cuda":
        return {"platform": "cpu", "device": "cpu", "power_limit": None}
    limit = None
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            limit = smi.stdout.strip()
    except FileNotFoundError:
        pass
    return {"platform": "gpu", "device": torch.cuda.get_device_name(device), "power_limit": limit}


def load_nominal_system(device=None):
    """The pem_v0 SPT-100 System on ``device``, logging to stdout."""
    from hallthrusterpem_tpu_torch.core.json_loader import load_system

    system = load_system(CONFIG, device=device)
    system.set_logger(stdout=True)
    return system


def conditions(lif: dict, jion: dict) -> list[dict]:
    """The batch's operating conditions: the scalar anchors, then the LIF and
    the Faraday pressures at 300 V and 5.16 mg/s."""
    conds = [dict(P_b=c["P_b"], V_a=c["V_a"], mdot_a=c["mdot_a"]) for c in SCALAR_ANCHORS]
    conds += [dict(P_b=pb, V_a=300.0, mdot_a=5.16e-6) for pb in lif]
    conds += [dict(P_b=pb, V_a=300.0, mdot_a=5.16e-6) for pb in jion]
    return conds


def score(conds: list[dict], out: dict, lif: dict, jion: dict) -> list[dict]:
    """The artifact's conditions: each scalar QoI's relative error, each
    profile's rel-L2, each beside its tolerance and verdict. ``out`` holds the
    System's outputs as numpy, one row per condition."""
    entries = []
    n_scalar = len(SCALAR_ANCHORS)
    for i, anchor in enumerate(SCALAR_ANCHORS):
        entry = {"name": anchor["name"],
                 "operating": {k: conds[i][k] for k in ("P_b", "V_a", "mdot_a")},
                 "qois": {}, "pass": True}
        for q, data_val in anchor["data"].items():
            model_val = float(out[q][i])
            rel = abs(model_val - data_val) / abs(data_val)
            ok = bool(np.isfinite(model_val) and rel <= anchor["tol"][q])
            entry["qois"][q] = {"data": data_val, "model": model_val,
                                "rel_err": round(rel, 4), "tol": anchor["tol"][q], "pass": ok}
            entry["pass"] = entry["pass"] and ok
        entries.append(entry)
        print(f"{anchor['name']}: pass={entry['pass']} "
              f"{ {q: round(r['rel_err'], 3) for q, r in entry['qois'].items()} }")

    # u_ion(z) rel-L2 on the LIF coordinates (z measured from the anode)
    zgrid = np.asarray(out["u_ion_coords"])
    for j, (pb, rows) in enumerate(sorted(lif.items())):
        i = n_scalar + j
        zrow = zgrid[i] if zgrid.ndim > 1 else zgrid
        err = rel_l2(rows[:, 3], rows[:, 4], zrow, out["u_ion"][i])
        ok = bool(np.isfinite(err) and err <= UION_TOL)
        entries.append({"name": f"uion_macdonald_{pb:.1e}Torr",
                        "operating": {"P_b": pb, "V_a": 300.0, "mdot_a": 5.16e-6},
                        "qois": {"u_ion": {"rel_l2": round(err, 4), "tol": UION_TOL,
                                           "n_points": int(len(rows)), "pass": ok}},
                        "pass": ok})
        print(f"{entries[-1]['name']}: rel_l2={err:.4f} pass={ok}")

    # j_ion(theta) rel-L2 on the Faraday angles (the model's sweep is 0-90 deg, 1 deg)
    theta_grid = np.asarray(out["j_ion_coords"])
    for j, (pb, (th_obs, j_obs)) in enumerate(sorted(jion.items())):
        i = n_scalar + len(lif) + j
        th_row = theta_grid[i] if theta_grid.ndim > 1 else theta_grid
        err = rel_l2(th_obs, j_obs, th_row, out["j_ion"][i])
        tol = JION_TOL[min(JION_TOL, key=lambda p: abs(p - pb))]
        ok = bool(np.isfinite(err) and err <= tol)
        entries.append({"name": f"jion_diamant_{pb:.1e}Torr",
                        "operating": {"P_b": pb, "V_a": 300.0, "mdot_a": 5.16e-6},
                        "qois": {"j_ion": {"rel_l2": round(err, 4), "tol": tol,
                                           "n_points": int(len(th_obs)), "pass": ok}},
                        "pass": ok})
        print(f"{entries[-1]['name']}: rel_l2={err:.4f} pass={ok}")
    return entries


def main(argv=None) -> dict:
    """Writes and returns the artifact (``"pass"``: every condition within its
    tolerances; ``"wall_s"``: the predict's seconds)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--output", default="runs/h100/anchors.json")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    system = load_nominal_system(args.device)
    lif, jion = lif_rows(), jion_groups()
    conds = conditions(lif, jion)
    t0 = time.perf_counter()
    out = to_numpy(system.predict(nominal_batch(system, conds), use_model="best"))
    wall = time.perf_counter() - t0

    artifact = {"date": date.today().isoformat(), **device_record(system.device),
                "config": f"hallthrusterpem_tpu_torch/configs/{CONFIG}", "wall_s": wall,
                "conditions": score(conds, out, lif, jion)}
    artifact["pass"] = all(e["pass"] for e in artifact["conditions"])
    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as fd:
        json.dump(artifact, fd, indent=1)
    print(f"{'PASS' if artifact['pass'] else 'FAIL'} -> {out_path}")
    return artifact


if __name__ == "__main__":
    raise SystemExit(0 if main()["pass"] else 1)
