"""Anomalous-profile shape sweep: what controls the u_ion(z) acceleration
width? (The JAX package's ``scripts/probe_anom_shape.py``.)

The candidate knobs are the TwoZoneBohm transition length ``l_t``, the
transport-barrier well depth and width, and the pressure-shift ``dz``. One
batched ``run_simulation`` (the K-step kernel on the card) runs the 12-case
design; each case reports its u_ion rel-L2 against the LIF profile at the
chosen pressure and its errors against the design-point T, I_d and I_B0.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.probe_anom_shape [-o runs/h100/anom_shape] [--pb 1e-5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu_torch.scripts._spt100 import design_errors, lif_rows, rel_l2, sweep_tree, to_numpy

# pem_v0 nominal calibration (pem_v0_SPT-100 inputs)
NOM = dict(l_t=1.87915e-3, a1=0.00680237, a2_mult=14.645, dz=0.2, z0=-0.03104,
           pstar=56.86006e-6, alpha=15.0, u_n=141.24234, depth=0.98)

# sweep design: (name, l_t [m], barrier depth, barrier 1-sigma width [m], shift dz)
W0 = 2.5e-3  # static default (SolverConfig.anom_barrier_width)
CASES = [
    ("nominal", NOM["l_t"], NOM["depth"], W0, 0.4),
    ("dz0.2", NOM["l_t"], NOM["depth"], W0, 0.2),
    ("dz0.2_w5", NOM["l_t"], NOM["depth"], 5e-3, 0.2),
    ("dz0.2_w8", NOM["l_t"], NOM["depth"], 8e-3, 0.2),
    ("dz0.2_w8_d0.9", NOM["l_t"], 0.9, 8e-3, 0.2),
    ("dz0.15_w8", NOM["l_t"], NOM["depth"], 8e-3, 0.15),
    ("dz0.3_w5", NOM["l_t"], NOM["depth"], 5e-3, 0.3),
    ("dz0.2_w12_d0.95", NOM["l_t"], 0.95, 12e-3, 0.2),
    ("dz0.25_w8_d0.95", NOM["l_t"], 0.95, 8e-3, 0.25),
    ("dz0.2_lt10_w5", 10e-3, NOM["depth"], 5e-3, 0.2),
    ("dz0.3", NOM["l_t"], NOM["depth"], W0, 0.3),
    ("dz0.25_w5", NOM["l_t"], NOM["depth"], 5e-3, 0.25),
]


def design_tree(pb: float) -> dict:
    """The input tree of the whole design at background pressure ``pb``: one row a case."""
    lt, depth, width, dz = (np.array([c[j] for c in CASES]) for j in range(1, 5))
    return sweep_tree(
        {"background_pressure_Torr": pb, "cathode_coupling_voltage": 31.8,
         "neutral_velocity": NOM["u_n"], "transition_length": lt},
        {"dz": dz, "z0": NOM["z0"], "pstar": NOM["pstar"], "alpha": NOM["alpha"],
         "model": {"type": "TwoZoneBohm", "c1": NOM["a1"], "c2": NOM["a1"] * NOM["a2_mult"],
                   "barrier_scale": depth, "barrier_width": width}})


def score(out: dict, pb: float) -> dict:
    """The report of the design's averaged outputs ``out`` (numpy, one row a case)."""
    groups = lif_rows()
    rows = next((r for p, r in groups.items() if np.isclose(p, pb)), None)
    if rows is None:
        rows = next(r for p, r in groups.items() if np.isclose(p, 1e-5))
    z_obs, u_obs = rows[:, 3], rows[:, 4]

    z = np.asarray(out["z"])
    ui = np.asarray(out["ui"][0])
    report = []
    print(f"{'case':>16} {'relL2':>6} {'T_err':>7} {'Id_err':>7} {'IB0_err':>7}")
    for i, (name, lt, depth, width, dz) in enumerate(CASES):
        zrow = z[i] if z.ndim > 1 else z
        rel = rel_l2(z_obs, u_obs, zrow, ui[i])
        errs = design_errors(out, i)
        report.append({"case": name, "l_t_mm": lt * 1e3, "depth": depth,
                       "width_mm": width * 1e3, "dz": dz,
                       "uion_rel_l2": round(rel, 4),
                       **{f"{q}_rel_err": round(e, 4) for q, e in errs.items()},
                       "u_grid": ui[i].tolist(), "z_grid": zrow.tolist(),
                       "E": np.asarray(out["E"])[i].tolist(),
                       "Te": np.asarray(out["Tev"])[i].tolist()})
        print(f"{name:>16} {rel:6.3f} {errs['T']:+7.1%} {errs['I_d']:+7.1%} {errs['I_B0']:+7.1%}")
    return {"pb": pb, "lif_z": z_obs.tolist(), "lif_u": u_obs.tolist(), "cases": report}


def main(argv=None) -> dict:
    """Writes ``anom_shape_<pb>.json`` and returns it."""
    from hallthrusterpem_tpu_torch.models.thruster import run_simulation

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--output", default="runs/h100/anom_shape")
    parser.add_argument("--pb", type=float, default=1e-5)
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    out = to_numpy(run_simulation(design_tree(args.pb), device=args.device)["output"]["average"])
    result = score(out, args.pb)
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    with open(outdir / f"anom_shape_{args.pb:.0e}.json", "w", encoding="utf-8") as fd:
        json.dump(result, fd)
    print(f"saved {outdir}/anom_shape_{args.pb:.0e}.json")
    return result


if __name__ == "__main__":
    main()
