"""Accuracy report of a trained MLP surrogate (the JAX package's
``scripts/surr_report.py``): held-out rel-L2 per QoI, the I_d error inside the
experimental envelope, per-sample error quantiles, the calibration of the
ensemble spread (global and binned conformal), and the eta_c tail. Writes a
JSON report next to the trained system (or to the absolute ``-o`` path).

The per-member forward pass runs on the system's device through the
ensemble's stacked members (``EnsembleMLP.forward``), in full float32.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.surr_report amisc_data [-o report.json] [--device cpu]
  python -m hallthrusterpem_tpu_torch.scripts.surr_report runs/r5/surr \\
      --config pem_v0_SPT-100_compression.json      # a run saved by the JAX package
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np
import torch

from hallthrusterpem_tpu_torch.core.json_loader import load_state, load_system
from hallthrusterpem_tpu_torch.surrogate.mlp import full_fp32

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("run_dir", nargs="?", default="amisc_data")
parser.add_argument("-o", "--output", default="report.json")
parser.add_argument("--envelope", nargs=2, type=float, default=[2.0, 8.0],
                    help="I_d envelope [A] containing the experimental data")
parser.add_argument("--config", default=None,
                    help="System JSON to load the run's *_trained*.state.pkl onto (a run saved by the JAX "
                         "package, which has no *_trained.json)")
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def load_trained(run_dir: Path, config=None, device=None):
    """The trained System of a run directory: its ``*_trained.json``, or with
    ``config`` that System with the run's trained state pickle loaded onto it."""
    if config is None:
        return load_system(next(run_dir.glob("*_trained.json")), device=device)
    system = load_system(config, device=device)
    load_state(system, next(run_dir.glob("*_trained*.state.pkl")))
    return system


def member_outputs(surr, xt: dict) -> np.ndarray:
    """Standardized outputs of every ensemble member, ``(K, n, P + 1)``."""
    xs = (surr.pack_inputs(xt).astype(np.float32) - surr.x_mu) / surr.x_sd
    with torch.no_grad(), full_fp32():
        out = surr.net(torch.as_tensor(xs, dtype=torch.float32, device=surr.device))
    return out.cpu().numpy()


def report(surr, test: dict, envelope=(2.0, 8.0)) -> dict:
    """Every number of the report, from a trained ``MLPSurrogate`` and a
    ``test_set.pkl`` dict (its NaN rows dropped)."""
    drop = test["nan_idx"] if "nan_idx" in test else test["discard"]
    keep = ~np.asarray(drop)
    xt = {k: np.asarray(v)[keep] for k, v in test["samples"].items()}
    yt = {k: np.asarray(v)[keep] for k, v in test["outputs"].items()}

    out = {"n_test": int(keep.sum()), "surrogate": surr.train_info | {
        "hidden": list(surr.hidden), "ensemble": surr.ensemble}}
    out["rel_l2"] = {k: round(float(v), 4) for k, v in sorted(surr.test_errors(xt, yt).items())}

    pred = {k: v.cpu().numpy() for k, v in surr.predict(xt).items()}
    lo, hi = envelope
    idt = np.asarray(yt["I_d"], dtype=float)
    idp = np.asarray(pred["I_d"], dtype=float)
    fin = np.isfinite(idt)
    rel = np.abs(idp - idt)[fin] / idt[fin]
    env = fin & (idt >= lo) & (idt < hi)
    out["I_d"] = {
        "global_rel_l2": round(float(np.linalg.norm((idp - idt)[fin]) / np.linalg.norm(idt[fin])), 4),
        "median_rel_err": round(float(np.median(rel)), 4),
        "p90_rel_err": round(float(np.percentile(rel, 90)), 4),
        "envelope_A": [lo, hi],
        "envelope_n": int(env.sum()),
        "envelope_rel_l2": round(float(np.linalg.norm((idp - idt)[env]) / np.linalg.norm(idt[env])), 4),
        "envelope_median_rel_err": round(float(np.median(np.abs(idp - idt)[env] / idt[env])), 4),
    }

    # ensemble-spread calibration on the I_d head, in the head's own space:
    # log10 when the trainer regressed I_d in log space, linear otherwise
    mem_all = member_outputs(surr, xt)
    ivar, col = next((var, start) for var, start, *_ in surr.out_slices if var.name == "I_d")
    log_head = "I_d" in (surr.log_names or ())
    mem = mem_all[..., col]
    y_sd_c, y_mu_c = float(np.asarray(surr.y_sd)[col]), float(np.asarray(surr.y_mu)[col])
    head_pred = mem.mean(axis=0)[fin] * y_sd_c + y_mu_c
    head_true = np.log10(idt[fin]) if log_head else np.asarray(ivar.normalize(idt[fin]), dtype=float)
    spread = mem.std(axis=0)[fin] * y_sd_c
    err = np.abs(head_pred - head_true)
    out["I_d"]["head_space"] = "log10" if log_head else "linear"
    out["I_d"]["spread_error_corr"] = round(float(np.corrcoef(spread, err)[0, 1]), 3)
    out["I_d"]["coverage_2sigma"] = round(float((err <= 2 * spread).mean()), 4)
    # deep ensembles under-disperse: one global inflation factor, then a table
    # binned by predicted spread (fit on one half, coverage on the other)
    ratio = err / np.maximum(spread, 1e-12)
    tau95 = float(np.quantile(ratio, 0.95)) / 2.0
    out["I_d"]["spread_tau_for_95pct"] = round(tau95, 3)
    out["I_d"]["coverage_2sigma_recalibrated"] = round(float((err <= tau95 * 2 * spread).mean()), 4)

    rng = np.random.default_rng(0)
    n = err.size
    cal = np.zeros(n, dtype=bool)
    cal[rng.permutation(n)[: n // 2]] = True
    n_bins = 5
    edges = np.quantile(spread[cal], np.linspace(0, 1, n_bins + 1))
    edges[0], edges[-1] = -np.inf, np.inf
    bins_cal = np.clip(np.searchsorted(edges, spread[cal], side="right") - 1, 0, n_bins - 1)
    bins_ev = np.clip(np.searchsorted(edges, spread[~cal], side="right") - 1, 0, n_bins - 1)
    table = []
    for b in range(n_bins):
        mc, mv = bins_cal == b, bins_ev == b
        if mc.sum() < 10 or mv.sum() < 10:
            continue
        tau_b = float(np.quantile(ratio[cal][mc], 0.95)) / 2.0
        cov_b = float((err[~cal][mv] <= tau_b * 2 * spread[~cal][mv]).mean())
        table.append({"spread_lo": round(float(edges[b]) if np.isfinite(edges[b]) else 0.0, 5),
                      "tau": round(tau_b, 3), "n_eval": int(mv.sum()),
                      "coverage_2sigma": round(cov_b, 4)})
    out["I_d"]["binned_calibration"] = table
    out["I_d"]["binned_min_coverage"] = round(min(t["coverage_2sigma"] for t in table), 4) if table else None

    # the eta_c tail: rows whose time-averaged beam/discharge current ratio
    # exceeds the steady-state bound eta_c <= 1 (breathing decouples the two
    # averages) dominate its global error; characterized, not remasked
    etc_t = np.asarray(yt["eta_c"], dtype=float)
    etc_p = np.asarray(pred["eta_c"], dtype=float)
    efin = np.isfinite(etc_t) & np.isfinite(etc_p)
    err2 = np.square((etc_p - etc_t)[efin])
    top10 = np.sort(err2)[-10:].sum() / max(err2.sum(), 1e-300)
    phys = efin & (etc_t <= 1.2)  # quasi-steady band (+20% averaging margin)
    rel_all = np.abs(etc_p - etc_t)[efin] / np.abs(etc_t)[efin]
    out["eta_c"] = {
        "global_rel_l2": round(float(np.linalg.norm((etc_p - etc_t)[efin]) / np.linalg.norm(etc_t[efin])), 4),
        "median_rel_err": round(float(np.median(rel_all)), 4),
        "top10_sq_err_frac": round(float(top10), 3),
        "physical_band": 1.2,
        "physical_n": int(phys.sum()),
        "physical_rel_l2": round(float(np.linalg.norm((etc_p - etc_t)[phys]) / np.linalg.norm(etc_t[phys])), 4),
        "derived_IB0_over_Id_rel_l2": round(float(np.linalg.norm(
            (np.asarray(pred["I_B0"], dtype=float) / np.asarray(pred["I_d"], dtype=float)
             - etc_t)[efin]) / np.linalg.norm(etc_t[efin])), 4),
    }
    return out


def main(argv=None):
    """Returns the report dict."""
    args = parser.parse_args(argv)
    run_dir = Path(args.run_dir)
    system = load_trained(run_dir, args.config, args.device)
    with open(run_dir / "test_set.pkl", "rb") as fd:
        test = pickle.load(fd)
    rep = report(system.system_surrogate, test, tuple(args.envelope))
    out_path = run_dir / args.output
    with open(out_path, "w") as fd:
        json.dump(rep, fd, indent=1)
    print(json.dumps(rep["rel_l2"], indent=None))
    print(json.dumps(rep["I_d"], indent=None))
    print(f"saved {out_path}")
    return rep


if __name__ == "__main__":
    main()
