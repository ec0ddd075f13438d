"""Round-5 nominal re-tune on the anode_edge_frac = 0.55 physics (the JAX
package's ``scripts/tune_r5.py``).

Samples calibration candidates (u_n, a_1, a_2, barrier depth, the plume cone
slope) from a scrambled Sobol' design over a box and runs every candidate at
the three LIF pressures in ONE batched ``run_simulation``: at ``-n 256``, 768
rows at 2e-3 s through the K-step kernel on the card. Each candidate is scored
against the ratcheted anchor table (hinge loss beyond T 2%, I_d 3%, I_B0 8%,
eta_m 6%, u_ion rel-L2 0.13 at every pressure, and a tie-break toward better
LIF fits); the table is sorted by score.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.tune_r5 [-n 256] [-o runs/h100/tune_nominals.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu_torch.scripts._spt100 import DESIGN_POINT, lif_rows, rel_l2, sweep_tree, to_numpy

# round-4 posterior-informed fixed values
FIXED = dict(l_t=1.87915e-3, dz=0.2, z0=-0.03104, pstar=56.86006e-6, alpha=15.0)
ANCHOR = {q: DESIGN_POINT[q] for q in ("T", "I_d", "I_B0", "eta_m")}  # at 1e-5 Torr
PBS = [1e-5, 3e-5, 5.5e-5]
VCC = [32.8, 33.6, 34.4]

#: sweep box: (low, high, log?). tan_div is the thrust cos-projection /
#: stream-tube cone slope (it raises T without touching I_B0; wall_recycling
#: lowers eta_m and I_B0 together).
BOX = {
    "u_n": (110.0, 220.0, False),
    "a1": (0.003, 0.014, True),
    "a2_mult": (6.0, 45.0, False),
    "anom_depth": (0.84, 1.0, False),
    "tan_div": (0.12, 0.45, False),
}

#: narrow refinement box around the wide sweep's winners (--box refine)
BOX_REFINE = {
    "u_n": (128.0, 168.0, False),
    "a1": (0.0050, 0.0078, True),
    "a2_mult": (28.0, 45.0, False),
    "anom_depth": (0.89, 1.0, False),
    "tan_div": (0.18, 0.30, False),
}


def sample_candidates(n: int, seed: int = 0, box: dict = None) -> dict:
    """``n`` candidates of a scrambled Sobol' design (``scipy.stats.qmc``) over ``box``."""
    from scipy.stats import qmc

    box = box or BOX
    eng = qmc.Sobol(d=len(box), seed=seed)
    u = eng.random(n)
    cand = {}
    for j, (name, (lo, hi, log)) in enumerate(box.items()):
        if log:
            cand[name] = 10 ** (np.log10(lo) + u[:, j] * (np.log10(hi) - np.log10(lo)))
        else:
            cand[name] = lo + u[:, j] * (hi - lo)
    return cand


def batch_tree(cand: dict, frac: float, width: float, wall_recycling: float = 0.93) -> dict:
    """The input tree of every candidate at the three LIF pressures (candidate-major)."""
    n = len(next(iter(cand.values())))
    rep = lambda v: np.repeat(np.asarray(v, dtype=np.float64), len(PBS))
    tile = lambda v: np.tile(np.asarray(v, dtype=np.float64), n)
    return sweep_tree(
        {"background_pressure_Torr": tile(PBS), "cathode_coupling_voltage": tile(VCC),
         "neutral_velocity": rep(cand["u_n"]), "transition_length": FIXED["l_t"],
         "anode_edge_frac": frac, "anode_edge_width": width, "wall_recycling": wall_recycling,
         "plume_divergence_tan": rep(cand["tan_div"]) if "tan_div" in cand else 0.364},
        {"dz": FIXED["dz"], "z0": FIXED["z0"], "pstar": FIXED["pstar"], "alpha": FIXED["alpha"],
         "model": {"type": "TwoZoneBohm", "c1": rep(cand["a1"]), "c2": rep(cand["a1"] * cand["a2_mult"]),
                   "barrier_scale": rep(cand["anom_depth"])}})


def run_batch(cand: dict, frac: float, width: float, wall_recycling: float = 0.93, device=None) -> dict:
    """One batched solve: every candidate at the three LIF pressures; the
    averaged outputs as numpy."""
    from hallthrusterpem_tpu_torch.models.thruster import run_simulation

    tree = batch_tree(cand, frac, width, wall_recycling)
    return to_numpy(run_simulation(tree, device=device)["output"]["average"])


def score_table(cand: dict, out: dict, lif_groups: dict) -> list[dict]:
    """One row a candidate (errors at 1e-5 Torr, u_ion rel-L2 at each
    pressure, score), sorted by score; a non-finite error scores inf."""
    n = len(next(iter(cand.values())))
    z = np.asarray(out["z"]).reshape(n, len(PBS), -1)
    ui = np.asarray(out["ui"][0]).reshape(n, len(PBS), -1)
    scal = {k: np.asarray(out[k]).reshape(n, len(PBS))
            for k in ("thrust", "discharge_current", "ion_current", "mass_eff", "current_eff")}
    rows = []
    for i in range(n):
        rel = [rel_l2(lif_groups[pb][:, 3], lif_groups[pb][:, 4], z[i, j], ui[i, j]) for j, pb in enumerate(PBS)]
        errs = {
            "T": float(scal["thrust"][i, 0] / ANCHOR["T"] - 1),
            "I_d": float(scal["discharge_current"][i, 0] / ANCHOR["I_d"] - 1),
            "I_B0": float(scal["ion_current"][i, 0] / ANCHOR["I_B0"] - 1),
            "eta_m": float(scal["mass_eff"][i, 0] / ANCHOR["eta_m"] - 1),
        }
        # hinge loss vs the ratcheted tolerances, quadratic beyond the band
        tol = {"T": 0.02, "I_d": 0.03, "I_B0": 0.08, "eta_m": 0.06}
        pen = sum(max(0.0, abs(e) - tol[q]) ** 2 / tol[q] ** 2 for q, e in errs.items())
        pen += sum(max(0.0, r - 0.13) ** 2 / 0.13**2 for r in rel)
        pen += 0.3 * float(np.mean(rel))  # tie-break toward better LIF fits
        if not all(np.isfinite(list(errs.values()))) or not all(np.isfinite(rel)):
            pen = np.inf
        rows.append({"idx": i, **{k: float(cand[k][i]) for k in cand},
                     **{f"{q}_err": round(e, 4) for q, e in errs.items()},
                     "uion_rel_l2": [round(r, 4) for r in rel],
                     "score": float(pen)})
    return sorted(rows, key=lambda r: r["score"])


def main(argv=None) -> dict:
    """Writes the best 50 rows and returns ``{"rows": all of them, sorted,
    "wall_s", "candidates", "out": the batch's averaged outputs}``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-n", "--num", type=int, default=256)
    parser.add_argument("--frac", type=float, default=0.55)
    parser.add_argument("--width", type=float, default=1.5e-3)
    parser.add_argument("--wall-recycling", type=float, default=0.93)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--box", choices=["wide", "refine"], default="wide")
    parser.add_argument("-o", "--output", default="runs/h100/tune_nominals.json")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    box = BOX_REFINE if args.box == "refine" else BOX
    cand = sample_candidates(args.num, seed=args.seed, box=box)
    t0 = time.time()
    out = run_batch(cand, args.frac, args.width, wall_recycling=args.wall_recycling, device=args.device)
    wall = time.time() - t0
    rows = score_table(cand, out, lif_rows())
    print(f"# {args.num} candidates x {len(PBS)} pressures in {wall:.1f}s")
    print(f"{'u_n':>7} {'a1':>9} {'a2m':>6} {'depth':>6} {'tand':>5} | {'T':>7} {'I_d':>7} "
          f"{'I_B0':>7} {'eta_m':>7} | {'relL2@1e-5/3e-5/5.5e-5':>24} | score")
    for r in rows[:20]:
        print(f"{r['u_n']:7.1f} {r['a1']:9.5f} {r['a2_mult']:6.1f} {r['anom_depth']:6.3f} "
              f"{r.get('tan_div', 0.364):5.2f} | "
              f"{r['T_err']:+7.1%} {r['I_d_err']:+7.1%} {r['I_B0_err']:+7.1%} "
              f"{r['eta_m_err']:+7.1%} | {r['uion_rel_l2']} | {r['score']:.3f}")

    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as fd:
        json.dump({"frac": args.frac, "width": args.width,
                   "wall_recycling": args.wall_recycling, "fixed": FIXED,
                   "box": {k: v[:2] for k, v in box.items()}, "wall_s": round(wall, 1),
                   "rows": rows[:50]}, fd, indent=1)
    print(f"saved {out_path}")
    return {"rows": rows, "wall_s": wall, "candidates": cand, "out": out}


if __name__ == "__main__":
    main()
