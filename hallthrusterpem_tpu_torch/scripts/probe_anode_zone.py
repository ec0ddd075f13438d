"""Near-anode conductive-zone sweep: can the u_ion mass-loading plateau
shrink? (The JAX package's ``scripts/probe_anode_zone.py``.)

Moves and widens the roll-off of the near-anode transport enhancement
(``anode_edge_frac``, ``anode_edge_width``) and reports the u_ion rel-L2 at the
three LIF pressures and the design-point errors of T, I_d and I_B0. Each case
is one batched ``run_simulation`` of the three pressures (the K-step kernel on
the card).

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.probe_anode_zone [-o runs/h100/anode_zone.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu_torch.scripts._spt100 import design_errors, lif_rows, rel_l2, sweep_tree, to_numpy

NOM = dict(l_t=1.87915e-3, a1=0.00680237, a2_mult=14.645, dz=0.2, z0=-0.03104,
           pstar=56.86006e-6, alpha=15.0, u_n=141.24234)
PBS = [1e-5, 3e-5, 5.5e-5]
VCC = [32.8, 33.6, 34.4]

#: (name, anode_edge_frac, anode_edge_width [m])
CASES = [
    ("frac_0.60", 0.60, 1.5e-3),
    ("frac_0.55", 0.55, 1.5e-3),
    ("frac_0.52", 0.52, 1.5e-3),
    ("frac_0.55_w3", 0.55, 3e-3),
]


def case_tree(frac: float, width: float) -> dict:
    """The input tree of one case: the three LIF pressures in a batch."""
    return sweep_tree(
        {"background_pressure_Torr": np.asarray(PBS), "cathode_coupling_voltage": np.asarray(VCC),
         "neutral_velocity": NOM["u_n"], "transition_length": NOM["l_t"],
         "anode_edge_frac": frac, "anode_edge_width": width},
        {"dz": NOM["dz"], "z0": NOM["z0"], "pstar": NOM["pstar"], "alpha": NOM["alpha"],
         "model": {"type": "TwoZoneBohm", "c1": NOM["a1"], "c2": NOM["a1"] * NOM["a2_mult"]}})


def run_case(frac: float, width: float, device=None) -> tuple:
    """``(PBS, averaged outputs as numpy)`` of one case."""
    from hallthrusterpem_tpu_torch.models.thruster import run_simulation

    return PBS, to_numpy(run_simulation(case_tree(frac, width), device=device)["output"]["average"])


def score_case(name: str, frac: float, width: float, pbs, out: dict, groups: dict) -> dict:
    """One case's report entry from its averaged outputs ``out``."""
    z = np.asarray(out["z"])
    ui = np.asarray(out["ui"][0])
    rels = []
    for i, pb in enumerate(pbs):
        rows = groups[pb]
        zrow = z[i] if z.ndim > 1 else z
        rels.append(rel_l2(rows[:, 3], rows[:, 4], zrow, ui[i]))
    errs = design_errors(out, 0)
    print(f"{name:>20} {rels[0]:10.3f} {rels[1]:7.3f} {rels[2]:8.3f} "
          f"{errs['T']:+7.1%} {errs['I_d']:+7.1%} {errs['I_B0']:+7.1%}")
    return {"case": name, "frac": frac, "width_mm": width * 1e3,
            "uion_rel_l2": [round(r, 4) for r in rels],
            **{f"{q}_rel_err": round(e, 4) for q, e in errs.items()}}


def main(argv=None) -> list[dict]:
    """Writes the report and returns it."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--output", default="runs/h100/anode_zone.json")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    groups = lif_rows()
    report = []
    print(f"{'case':>20} {'relL2@1e-5':>10} {'@3e-5':>7} {'@5.5e-5':>8} "
          f"{'T_err':>7} {'Id_err':>7} {'IB0_err':>7}")
    for name, frac, width in CASES:
        pbs, out = run_case(frac, width, args.device)
        report.append(score_case(name, frac, width, pbs, out, groups))

    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as fd:
        json.dump(report, fd, indent=1)
    print(f"saved {out_path}")
    return report


if __name__ == "__main__":
    main()
