"""The u_ion(z) anchor gap: the nominal model's profile against the
MacDonald-Tenenbaum LIF data (the JAX package's ``scripts/probe_uion.py``).

Runs the pem_v0 nominal System at the three LIF pressures (one batch, through
the K-step kernel on the card) and saves the profiles and an error
decomposition: the rel-L2, what a least-squares axial shift (brute force over
+-5 mm) or velocity scale would leave, and the mean chi^2 against the LIF
uncertainty, so that the gap is attributable to a mechanism.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.probe_uion [-o runs/h100/uion_probe] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu_torch.scripts._spt100 import lif_rows, nominal_batch, to_numpy


def decompose(groups: dict, z_model, u_model) -> list[dict]:
    """One record per LIF pressure (ascending): the rel-L2 of the model profile
    row ``i`` on the data points, the best shift and scale and what they leave,
    the mean chi^2, and the profiles."""
    z_model = np.asarray(z_model, dtype=np.float64)
    u_model = np.asarray(u_model, dtype=np.float64)
    report = []
    for i, (pb, rows) in enumerate(sorted(groups.items())):
        z_obs, u_obs, du_obs = rows[:, 3], rows[:, 4], rows[:, 5]
        zrow = z_model[i] if z_model.ndim > 1 else z_model
        u_interp = np.interp(z_obs, zrow, u_model[i])
        err = u_interp - u_obs
        rel_l2 = float(np.linalg.norm(err) / np.linalg.norm(u_obs))
        # best axial shift: does the error look like a misplaced acceleration region?
        shifts = np.linspace(-5e-3, 5e-3, 201)
        l2s = [np.linalg.norm(np.interp(z_obs + s, zrow, u_model[i]) - u_obs) for s in shifts]
        s_best = float(shifts[int(np.argmin(l2s))])
        rel_l2_shift = float(np.min(l2s) / np.linalg.norm(u_obs))
        # best velocity scale: is it a terminal-velocity (energy) mismatch?
        alpha = float((u_interp @ u_obs) / (u_interp @ u_interp))
        rel_l2_scale = float(np.linalg.norm(alpha * u_interp - u_obs) / np.linalg.norm(u_obs))
        chi2 = float(np.mean((err / np.maximum(du_obs, 1.0)) ** 2))
        report.append({"P_b": pb, "rel_l2": round(rel_l2, 4),
                       "rel_l2_best_shift": round(rel_l2_shift, 4), "best_shift_mm": round(s_best * 1e3, 2),
                       "rel_l2_best_scale": round(rel_l2_scale, 4), "best_scale": round(alpha, 4),
                       "mean_chi2_vs_lif_sigma": round(chi2, 2),
                       "z_obs": z_obs.tolist(), "u_obs": u_obs.tolist(), "du_obs": du_obs.tolist(),
                       "u_model": u_interp.tolist(),
                       "z_grid": zrow.tolist(), "u_grid": u_model[i].tolist()})
        print(f"P_b={pb:.1e}: rel_l2={rel_l2:.3f}  best-shift {s_best * 1e3:+.1f} mm -> "
              f"{rel_l2_shift:.3f}  best-scale {alpha:.3f} -> {rel_l2_scale:.3f}  "
              f"chi2/sigma^2={chi2:.1f}")
    return report


def save_plot(report: list[dict], path: Path) -> None:
    """The model profile against the LIF points, one panel per pressure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(report), figsize=(4 * len(report), 3.2), sharey=True)
    for ax, entry in zip(np.atleast_1d(axes), report):
        ax.errorbar(np.array(entry["z_obs"]) * 1e3, np.array(entry["u_obs"]) * 1e-3,
                    yerr=np.array(entry["du_obs"]) * 1e-3, fmt="o", ms=3, label="LIF")
        ax.plot(np.array(entry["z_grid"]) * 1e3, np.array(entry["u_grid"]) * 1e-3, "-", label="model")
        ax.set_title(f"P_b={entry['P_b']:.1e} Torr (relL2 {entry['rel_l2']:.2f})")
        ax.set_xlabel("z from anode [mm]")
        ax.set_xlim(0, 60)
    np.atleast_1d(axes)[0].set_ylabel("u_ion [km/s]")
    np.atleast_1d(axes)[0].legend()
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def main(argv=None) -> list[dict]:
    """Writes ``uion_probe.json`` (and, with matplotlib, ``uion_probe.png``) and
    returns the report."""
    from hallthrusterpem_tpu_torch.scripts.anchors import load_nominal_system

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-o", "--output", default="runs/h100/uion_probe")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    system = load_nominal_system(args.device)
    groups = lif_rows()
    conds = [dict(P_b=pb, V_a=300.0, mdot_a=5.16e-6) for pb in sorted(groups)]
    out = to_numpy(system.predict(nominal_batch(system, conds), use_model="best"))
    report = decompose(groups, out["u_ion_coords"], out["u_ion"])

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    with open(outdir / "uion_probe.json", "w", encoding="utf-8") as fd:
        json.dump(report, fd)
    try:
        save_plot(report, outdir / "uion_probe.png")
        print(f"saved {outdir / 'uion_probe.png'}")
    except ImportError as err:
        print(f"plotting skipped: {err}")
    return report


if __name__ == "__main__":
    main()
