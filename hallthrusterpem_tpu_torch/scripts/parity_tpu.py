"""Kernel against lax solver on the card (the JAX package's ``scripts/parity_tpu.py``).

The CPU tests hold each solver's plain PyTorch version against JAX; they cannot
see how the card computes. This script runs the same physics through both of
the port's solvers on the card, the K-step CUDA kernel (``solver="kstep"``) and
the lax solver replayed as CUDA graphs (``solver="lax"``), at the production
operating envelope (the nominal point and four corners, fixed seeds, 2e-3 s),
and writes a pass/fail artifact (``runs/h100/parity.json``) that
``tests/test_torch_parity_artifact.py`` validates.

Divergent failure masks on basin-boundary samples are expected physics (two
numerically equivalent paths can tip different marginal samples into another
attractor over a 2 ms horizon): the artifact records the mask agreement against
a floor, and QoI errors are compared over the rows both solvers put in the same
attractor. The artifact records the card's name and power limit, the lax
solver's ms a step and the kernel's launches.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.parity_tpu [-o runs/h100/parity.json] [-B 32] [--device cpu]
  python -m hallthrusterpem_tpu_torch.scripts.parity_tpu --reeval [-o runs/h100/parity.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from datetime import date
from pathlib import Path

import numpy as np
import torch

# QoI tolerances on the rows both solvers put in the same attractor: the median
# is the drift claim, the p90 (key "max") bounds the bulk; cycle-averaged
# labels carry ~1% from limit-cycle phase differences
TOLERANCES = {
    "T": {"median": 0.015, "max": 0.05},
    "I_d": {"median": 0.02, "max": 0.10},
    "I_B0": {"median": 0.02, "max": 0.10},
}
# floors on the fraction of rows whose failure mask / attractor must agree
# (measured on the TPU: 5/32 rows may flip their failure decision between
# numerically equivalent solvers over 2 ms)
MIN_MASK_AGREEMENT = 0.75
MIN_ATTRACTOR_AGREEMENT = 0.9
#: ceiling on any same-attractor row's divergence (the attractor cut is 30%)
MAX_REL_SAME_ATTRACTOR = 0.30

CONFIGS = [
    {"name": "nominal_300V_5.16mg", "V_a": 300.0, "mdot_a": 5.16e-6, "P_b": 1e-5},
    {"name": "low_flow_250V_3.5mg", "V_a": 250.0, "mdot_a": 3.5e-6, "P_b": 5e-6},
    {"name": "high_V_400V_high_Pb", "V_a": 400.0, "mdot_a": 5.16e-6, "P_b": 3e-5},
    # quench-adjacent corner: low flow and weak anomalous transport exercise the
    # physicality guards and the mask accounting
    {"name": "quench_corner_low_a1", "V_a": 280.0, "mdot_a": 3.0e-6, "P_b": 1e-5,
     "a_1": 0.004},
    # two-group neutrals at nominal: the kernel's kstep<3,2> variant
    {"name": "two_group_nominal", "V_a": 300.0, "mdot_a": 5.16e-6, "P_b": 1e-5,
     "neutral_groups": 2},
]

#: the solvers compared and the artifact's key for each (JAX's "pallas" is the kernel)
ROUTES = {"lax": "lax", "pallas": "kstep"}


def inputs_for(cond: dict, batch: int, seed: int) -> dict:
    """The seeded numpy inputs of a condition (the JAX script's draws)."""
    rng = np.random.default_rng(seed)
    return {
        "P_b": np.full(batch, cond["P_b"], np.float64),
        "V_a": cond["V_a"] * (1 + 0.04 * rng.standard_normal(batch)),
        "mdot_a": cond["mdot_a"] * (1 + 0.04 * rng.standard_normal(batch)),
        "V_cc": np.full(batch, 30.0),
        "u_n": 141.24 * (1 + 0.05 * rng.standard_normal(batch)),
        "a_1": cond.get("a_1", 0.0068) * (1 + 0.1 * rng.standard_normal(batch)),
        "a_2": np.full(batch, 14.645),  # ratio on a_1 (the wrapper's c2 = a_2 * c1)
        "dz": np.full(batch, 0.2),
        "z0": np.full(batch, -0.03104),
        "p0": np.full(batch, 56.86e-6),
    }


def thruster_config(cond: dict) -> dict:
    """The production pem_v0 Thruster config (``configs/pem_v0_SPT-100.json``):
    pressure-shifted TwoZoneBohm, the facility RL filter, plume and divergence."""
    config = {
        "ncharge": 3,
        "domain": (0.0, 0.08),
        "ion_wall_losses": True,
        "solve_plume": True,
        "apply_thrust_divergence_correction": True,
        "circuit": {"R": 0.5, "L": 0.0},
        "anom_model": {"type": "LogisticPressureShift", "dz": 0.2, "z0": -0.03104,
                       "pstar": 45.0e-6, "alpha": 15,
                       "model": {"type": "TwoZoneBohm", "c1": 0.00625, "c2": 0.0625}},
    }
    if cond.get("neutral_groups"):
        config["neutral_groups"] = cond["neutral_groups"]
    return config


def score(cond: dict, batch: int, seed: int, lax_out: dict, pl_out: dict) -> dict:
    """The mask, attractor and per-QoI accounting of one condition (numpy
    outputs of the two solvers), without the timings."""
    entry = {"condition": cond, "batch": batch, "seed": seed, "qois": {}}
    fin_l = np.isfinite(lax_out["T"])
    fin_p = np.isfinite(pl_out["T"])
    agree = float((fin_l == fin_p).mean())
    both = fin_l & fin_p
    # parity is judged on rows where both solvers found the same attractor
    # (I_d within 30%); the divergent fraction is bounded instead
    same = both & (np.abs(np.log(np.maximum(lax_out["I_d"], 1e-9) /
                                 np.maximum(pl_out["I_d"], 1e-9))) < np.log(1.3))
    attractor_agree = float(same.sum() / max(both.sum(), 1))
    entry["finite"] = {"lax": int(fin_l.sum()), "pallas": int(fin_p.sum()),
                       "mask_agreement": round(agree, 4), "both": int(both.sum()),
                       "attractor_agreement": round(attractor_agree, 4),
                       "same_attractor": int(same.sum())}
    ok = (agree >= MIN_MASK_AGREEMENT and attractor_agree >= MIN_ATTRACTOR_AGREEMENT
          and same.sum() > 0)
    for qoi, tol in TOLERANCES.items():
        if qoi not in lax_out or not same.any():
            continue
        a, b = lax_out[qoi][same], pl_out[qoi][same]
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-12)
        rec = {"median_rel": float(np.median(rel)), "p90_rel": float(np.percentile(rel, 90)),
               "max_rel": float(rel.max()),
               "tol_median": tol["median"], "tol_p90": tol["max"],
               "tol_max": MAX_REL_SAME_ATTRACTOR,
               "pass": bool(np.median(rel) < tol["median"]
                            and np.percentile(rel, 90) < tol["max"]
                            and rel.max() < MAX_REL_SAME_ATTRACTOR)}
        entry["qois"][qoi] = rec
        ok = ok and rec["pass"]
    entry["pass"] = bool(ok)
    return entry


def solve(cond: dict, route: str, batch: int, seed: int, fidelity=(2, 2), device=None,
          duration: float = 2e-3) -> tuple:
    """One route (``"lax"`` or ``"kstep"``) on one condition through
    ``hallthruster_jl``: its outputs (numpy), its seconds to a card sync, the
    steps it ran (from the tree it ran) and the ``kstep`` launches counted
    meanwhile. ``duration`` is the horizon, its second half
    the averaging window."""
    from hallthrusterpem_tpu_torch.models.thruster import _kernels, _tree_to_solver_inputs, hallthruster_jl
    from hallthrusterpem_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    inputs = {k: torch.as_tensor(v, device=device) for k, v in inputs_for(cond, batch, seed).items()}
    kw = dict(thruster="SPT-100", model_fidelity=fidelity, config=thruster_config(cond),
              simulation={"duration": duration},
              postprocess={"average_start_time": duration / 2, "cycle_average": True, "num_save": 256})
    before = _kernels.launch_counts["kstep"]
    t0 = time.time()
    out = hallthruster_jl(inputs, solver=route, device=device, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    steps = _tree_to_solver_inputs(out["thruster_output"], "cpu")[0].num_steps
    return ({k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}, wall, steps,
            _kernels.launch_counts["kstep"] - before)


def run_config(cond: dict, batch: int, seed: int, fidelity=(2, 2), device=None, duration: float = 2e-3) -> dict:
    """Both solvers on one condition (:func:`solve`: the lax solver, then the
    kernel), scored by :func:`score`."""
    lax_out, lax_s, steps, _ = solve(cond, "lax", batch, seed, fidelity, device, duration)
    pl_out, pl_s, _, launches = solve(cond, "kstep", batch, seed, fidelity, device, duration)
    entry = score(cond, batch, seed, lax_out, pl_out)
    entry["wall_s"] = {"lax": round(lax_s, 2), "pallas": round(pl_s, 2)}
    entry["steps"] = steps
    entry["lax_ms_per_step"] = lax_s / steps * 1e3
    entry["kstep_launches"] = launches
    return entry


def reeval(path: Path) -> int:
    """Recompute the pass flags of an artifact from its recorded numbers under
    the criteria above; the measured numbers are never altered."""
    with open(path) as fd:
        art = json.load(fd)
    for entry in art["configs"]:
        fin = entry["finite"]
        if "attractor_agreement" not in fin or "same_attractor" not in fin:
            raise SystemExit(f"{path}: artifact lacks attractor_agreement/"
                             "same_attractor: re-run parity_tpu on the card")
        ok = (fin["mask_agreement"] >= MIN_MASK_AGREEMENT
              and fin["attractor_agreement"] >= MIN_ATTRACTOR_AGREEMENT
              and fin["same_attractor"] > 0)
        for qoi, rec in entry["qois"].items():
            tol = TOLERANCES.get(qoi, {})
            rec["tol_median"] = tol.get("median", rec["tol_median"])
            rec["tol_p90"] = tol.get("max", rec.get("tol_p90", rec.get("tol_max")))
            rec["tol_max"] = MAX_REL_SAME_ATTRACTOR
            rec["pass"] = bool(rec["median_rel"] < rec["tol_median"]
                               and rec.get("p90_rel", rec["max_rel"]) < rec["tol_p90"]
                               and rec["max_rel"] < MAX_REL_SAME_ATTRACTOR)
            ok = ok and rec["pass"]
        entry["pass"] = bool(ok)
        print(f"{entry['condition']['name']}: pass={entry['pass']} "
              f"mask={fin['mask_agreement']} attractor={fin.get('attractor_agreement')}")
    art["min_mask_agreement"] = MIN_MASK_AGREEMENT
    art["pass"] = all(e["pass"] for e in art["configs"])
    with open(path, "w") as fd:
        json.dump(art, fd, indent=1)
    print(f"{'PASS' if art['pass'] else 'FAIL'} -> {path} (re-evaluated)")
    return 0 if art["pass"] else 1


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--output", default="runs/h100/parity.json")
    parser.add_argument("-B", "--batch", type=int, default=32)
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--reeval", action="store_true",
                        help="recompute the pass flags of the existing artifact under the current "
                             "criteria (no solve)")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    if args.reeval:
        return reeval(Path(args.output))

    from hallthrusterpem_tpu_torch.scripts.anchors import device_record
    from hallthrusterpem_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    artifact = {"date": date.today().isoformat(), **device_record(device),
                "min_mask_agreement": MIN_MASK_AGREEMENT, "configs": []}
    if device.type != "cuda":
        print(f"WARNING: running on {device}, not a card: artifact marked {artifact['platform']}",
              file=sys.stderr)
    for cond in CONFIGS:
        entry = run_config(cond, args.batch, args.seed, device=device)
        artifact["configs"].append(entry)
        print(f"{cond['name']}: pass={entry['pass']} "
              f"finite l/p={entry['finite']['lax']}/{entry['finite']['pallas']} "
              f"lax {entry['lax_ms_per_step']:.3f} ms/step, {entry['kstep_launches']} kstep launches "
              f"{ {k: round(v['max_rel'], 4) for k, v in entry['qois'].items()} }", flush=True)
    artifact["pass"] = all(e["pass"] for e in artifact["configs"])

    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as fd:
        json.dump(artifact, fd, indent=1)
    print(f"{'PASS' if artifact['pass'] else 'FAIL'} -> {out}")
    return 0 if artifact["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
