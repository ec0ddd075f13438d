"""Forward Monte Carlo UQ of the PEM v0 (the JAX package's
``scripts/pem_v0/monte_carlo.py``): prior or posterior predictive sampling over
background pressures or at experimental operating conditions, surrogate against
the true model and against the data (per-condition medians, relative-L2
tables), SVD field reconstruction, percentile summaries, results in ``.npz``.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.pem_v0.monte_carlo pem_v0_SPT-100_trained.json \\
      --data spt100 -n 64 --posterior chain.npz --compare-model
Medians and percentiles are numpy's, on the host (``torch.nanmedian`` would
take the lower middle value of an even count). ``--plots`` (with ``--data``)
saves the predictive figures and the surrogate slices into the working
directory; it needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from hallthrusterpem_tpu_torch.core.dataset import to_numpy
from hallthrusterpem_tpu_torch.core.json_loader import find_latest_save
from hallthrusterpem_tpu_torch.core.system import System
from hallthrusterpem_tpu_torch.scripts.pem_v0.dataset_util import SCALAR_COLS, field_profiles, load_experiment
from hallthrusterpem_tpu_torch.uq import mc_percentiles, read_mcmc_chain
from hallthrusterpem_tpu_torch.uq.montecarlo import l2_error_table

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("config_file")
parser.add_argument("--search", action="store_true", help="use the newest save under the config's directory")
parser.add_argument("-n", "--num_samples", type=int, default=1000)
parser.add_argument("--pressures", nargs="*", type=float, default=[3e-6, 1e-5, 3e-5, 5e-5, 8e-5])
parser.add_argument("--data", nargs="*", default=None,
                    help="experimental CSVs (or 'spt100' for the bundled datasets): evaluate at the "
                         "experimental operating conditions and tabulate prediction-vs-data errors")
parser.add_argument("--compare-model", action="store_true",
                    help="also run the true model and print relative-L2 tables")
parser.add_argument("--posterior", default=None, help=".npz MCMC chain to sample the calibration from")
parser.add_argument("--qois", nargs="*", default=["V_cc", "T", "I_d", "I_B0", "eta_a"])
parser.add_argument("--allocation", action="store_true",
                    help="print the MISC cost allocation of a trained surrogate")
parser.add_argument("--plots", action="store_true",
                    help="save predictive figures: per-QoI 5-95%% bands against background pressure with "
                         "the experimental error bars, u_ion(z) and j_ion(theta) bands against the data, "
                         "and slice plots of the trained surrogate")
parser.add_argument("--out", default="mc_results.npz",
                    help="the pressure sweep's outputs, as arrays 'P_b_<p>/<output>'")
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")

#: ``use_model`` of each column of the experimental comparison
SOURCES = {"surrogate": None, "model": "best"}


def print_allocation(system):
    """MISC cost allocation of a trained surrogate: per component and model
    fidelity alpha, the evaluations spent and their wall-clock cost, and the
    active/candidate index-set sizes."""
    cost_alloc, model_cost, overhead, model_evals = system.get_allocation()
    print(f"# MISC allocation: total model cost {model_cost:.1f}s, training overhead {overhead:.1f}s")
    print(f"{'component':>12} {'alpha':>10} {'evals':>7} {'cost[s]':>9} {'frac':>6}")
    for comp_name, per_alpha in cost_alloc.items():
        for alpha, cost in sorted(per_alpha.items()):
            n = model_evals[comp_name][alpha]
            frac = cost / model_cost if model_cost > 0 else 0.0
            print(f"{comp_name:>12} {str(alpha):>10} {n:7d} {cost:9.2f} {frac:6.1%}")
    for comp in system.components:
        surr = getattr(comp, "surrogate", None)
        if surr is not None:
            alphas = sorted({k[: surr.n_alpha] for k in surr.active})
            print(f"{comp.name}: {len(surr.active)} active / {len(surr.candidates)} candidate "
                  f"multi-indices; active alphas {alphas}")


def posterior_draws(posterior: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """``n`` rows of a flattened chain, drawn with replacement by ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return posterior[rng.integers(0, len(posterior), n)]


def experiment_samples(system, ops: dict, n_draws: int, draws: Optional[np.ndarray] = None,
                       calib_names: Sequence[str] = (), seed: int = 7) -> dict:
    """The (n_draws x n_ops) input batch, draw-major: operating inputs pinned to
    the conditions, calibration and nuisance drawn from their pdfs (a
    ``torch.Generator`` seeded ``seed``), the calibration replaced by the
    posterior ``draws`` where given."""
    n_ops = len(ops["P_b"])
    samples = system.sample_inputs(n_draws * n_ops, seed=seed, use_pdf=["calibration", "nuisance"],
                                   constants=["operating"])
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=system.device)
    for name in ("P_b", "V_a", "mdot_a"):
        if name in samples:
            samples[name] = put(np.tile(ops[name], n_draws))
    if draws is not None:
        for i, name in enumerate(list(calib_names)[: draws.shape[1]]):
            samples[name] = put(np.repeat(draws[:, i], n_ops))
    return samples


def run_experimental_comparison(system, args, posterior, calib_names, draws=None, sources=None) -> dict:
    """Evaluate at the experimental operating conditions and tabulate each
    source (the surrogate, and with ``--compare-model`` the true model) against
    the data: per-condition medians and rel-L2 across conditions for the
    scalars; rel-L2 of the median profile per condition for the fields.

    :param posterior: flattened chain (or None for the prior); ``args.num_samples``
        rows are drawn from it by ``default_rng(0)``, unless ``draws`` gives them
    :param sources: the columns, names in :data:`SOURCES` (default: the
        surrogate, and the model with ``--compare-model``)
    :returns: ``{"ops", "obs", "samples", "preds", "median": {q: {src: (n_ops,)}},
        "rel_l2": {q: {src: float}}, "field_rel_l2": {q: {src: [...]}}}``
    """
    qois = [q for q in args.qois if q in SCALAR_COLS or q in ("u_ion", "j_ion")]
    ops, obs, sig, fields = load_experiment(args.data, qois)
    n_ops = len(ops["P_b"])
    Nmc = args.num_samples if draws is None else len(draws)
    print(f"# {n_ops} experimental operating conditions, {Nmc} draws each")
    if draws is None and posterior is not None:
        draws = posterior_draws(posterior, Nmc)
    samples = experiment_samples(system, ops, Nmc, draws, calib_names)

    if sources is None:
        sources = ["surrogate"] + (["model"] if args.compare_model else [])
    preds = {src: system.predict(samples, use_model=SOURCES[src], qoi_ind=qois) for src in sources}
    result = {"ops": ops, "obs": obs, "samples": samples, "preds": preds,
              "median": {}, "rel_l2": {}, "field_rel_l2": {}}

    # scalar tables: per-condition medians vs data, rel-L2 across conditions
    for q in [q for q in qois if q in obs]:
        mask = np.isfinite(obs[q])
        if not mask.any():
            continue
        print(f"\n== {q} (vs data at {int(mask.sum())} conditions)")
        meds = {}
        for src, pred in preds.items():
            p = np.asarray(to_numpy(pred[q]), dtype=float).reshape(Nmc, n_ops)
            meds[src] = np.nanmedian(p, axis=0)
        hdr = f"{'V_a':>5} {'mdot':>9} {'P_b':>9} {'data':>10}" + "".join(f"{s:>11}" for s in meds)
        print(hdr)
        for k in np.where(mask)[0]:
            row = f"{ops['V_a'][k]:5.0f} {ops['mdot_a'][k]:9.2e} {ops['P_b'][k]:9.2e} {obs[q][k]:10.4g}"
            row += "".join(f"{meds[s][k]:11.4g}" for s in meds)
            print(row)
        result["median"][q] = meds
        result["rel_l2"][q] = {}
        for src, med in meds.items():
            num = np.linalg.norm(med[mask] - obs[q][mask])
            den = np.linalg.norm(obs[q][mask]) + 1e-300
            result["rel_l2"][q][src] = float(num / den)
            print(f"rel-L2 {src} vs data: {num / den:.3e}")

    # field tables: median profile interpolated onto the data coordinates
    for q, specs in fields.items():
        print(f"\n== {q} (field, vs data)")
        result["field_rel_l2"][q] = {}
        for src, pred in preds.items():
            prof, grid = field_profiles(system, pred, q)
            prof = prof.reshape(Nmc, n_ops, -1)
            grid = grid.reshape(Nmc, n_ops, -1)
            errs = []
            for k, spec in enumerate(specs):
                if spec is None:
                    continue
                med = np.nanmedian(prof[:, k, :], axis=0)
                interp = np.interp(spec["coords"], grid[0, k], med)
                num = np.linalg.norm(interp - spec["vals"])
                den = np.linalg.norm(spec["vals"]) + 1e-300
                errs.append(float(num / den))
                print(f"  {src} cond {k} (V_a={ops['V_a'][k]:.0f}, P_b={ops['P_b'][k]:.1e}): "
                      f"rel-L2 {num / den:.3e}")
            result["field_rel_l2"][q][src] = errs
            if errs:
                print(f"rel-L2 {src} vs data (mean over conditions): {np.mean(errs):.3e}")

    if args.plots:
        tag = "_post" if posterior is not None else "_prior"
        saved = save_predictive_plots(system, args, ops, obs, sig, fields, preds, Nmc, n_ops, tag)
        saved += save_surrogate_slices(system, args)
        print("saved figures:", ", ".join(saved))
    return result


def save_predictive_plots(system, args, ops, obs, sig, fields, preds, Nmc, n_ops, tag="") -> list:
    """Predictive figures against the experimental data: for each scalar QoI the
    5-95% band and median over background pressure with 2-sigma error bars;
    u_ion(z) / j_ion(theta) bands at each measured condition. Returns the file
    names written."""
    from hallthrusterpem_tpu_torch.viz import _pyplot, ax_default

    plt = _pyplot()
    saved = []
    pb = np.asarray(ops["P_b"], dtype=float)
    for q in [q for q in args.qois if q in obs]:
        mask = np.isfinite(obs[q])
        if not mask.any():
            continue
        fig, axes = plt.subplots(1, len(preds), figsize=(4.2 * len(preds), 3.2), squeeze=False)
        for ax, (src, pred) in zip(axes[0], preds.items()):
            p = np.asarray(to_numpy(pred[q]), dtype=float).reshape(Nmc, n_ops)[:, mask]
            x = pb[mask]
            idx = np.argsort(x)
            p5, med, p95 = np.nanpercentile(p, [5, 50, 95], axis=0)
            ax.fill_between(x[idx], p5[idx], p95[idx], alpha=0.25, color="0.4", label=f"{src} 5-95%")
            ax.plot(x[idx], med[idx], "-k", lw=1.2, label=f"{src} median")
            ax.errorbar(x[idx], obs[q][mask][idx], yerr=2 * sig[q][mask][idx], fmt="o",
                        ms=4, capsize=3, mfc="none", color="r", label="experiment")
            ax.set_xscale("log")
            ax_default(ax, "Background pressure (Torr)", q, legend=True)
        fig.tight_layout()
        name = f"mc_{q}{tag}.png"
        fig.savefig(name, dpi=130)
        plt.close(fig)
        saved.append(name)

    for q, specs in fields.items():
        n_meas = sum(s is not None for s in specs)
        if n_meas == 0:
            continue
        ncols = min(n_meas, 4)
        nrows = (n_meas + ncols - 1) // ncols
        fig, axes = plt.subplots(nrows, ncols, figsize=(3.6 * ncols, 2.9 * nrows), squeeze=False)
        flat_axes = [ax for row in axes for ax in row]
        for src, pred in preds.items():
            prof, grid = field_profiles(system, pred, q)
            prof = prof.reshape(Nmc, n_ops, -1)
            grid = grid.reshape(Nmc, n_ops, -1)
            i_ax = 0
            for k, spec in enumerate(specs):
                if spec is None:
                    continue
                ax = flat_axes[i_ax]
                g = grid[0, k]
                p5, med, p95 = np.nanpercentile(prof[:, k, :], [5, 50, 95], axis=0)
                ax.fill_between(g, p5, p95, alpha=0.2, color="0.4")
                ax.plot(g, med, "-" if src == "surrogate" else "--", c="k", lw=1.2, label=src)
                if src == list(preds)[0]:
                    ax.errorbar(spec["coords"], spec["vals"], yerr=2 * spec["stds"], fmt="o",
                                ms=3, capsize=2, mfc="none", color="r", label="experiment")
                ax.set_title(f"V_a={ops['V_a'][k]:.0f} V, P_b={ops['P_b'][k]:.1e} Torr", fontsize=8)
                ax_default(ax, "angle (rad)" if q == "j_ion" else "z (m)", q, legend=(i_ax == 0))
                if q == "j_ion":
                    ax.set_yscale("log")
                i_ax += 1
        for ax in flat_axes[n_meas:]:
            ax.set_visible(False)
        fig.tight_layout()
        name = f"mc_{q}{tag}.png"
        fig.savefig(name, dpi=130)
        plt.close(fig)
        saved.append(name)
    return saved


def save_surrogate_slices(system, args) -> list:
    """1-D slice plots over the first four calibration inputs, model against the
    trained surrogate (best-effort: a failure is logged and nothing is saved)."""
    inputs = [v.name for v in system.inputs() if v.category == "calibration"][:4]
    if not inputs:
        return []
    qois = [q for q in args.qois if q in {v.name for v in system.outputs()}][:3]
    try:
        system.plot_slice(inputs, qois, show_model=["best"], num_steps=12, save_path="mc_surrogate_slices.png")
    except Exception as err:  # slice plotting is best-effort, as in the JAX package
        system.logger.warning("surrogate slice plot skipped: %s", err, exc_info=True)
        return []
    return ["mc_surrogate_slices.png"]


def _save_npz(path, arrays: dict):
    tmp = Path(str(path) + ".tmp")
    with open(tmp, "wb") as fd:
        np.savez(fd, **arrays)
    os.replace(tmp, path)


def main(argv=None):
    args = parser.parse_args(argv)
    path = find_latest_save(args.config_file) if args.search else Path(args.config_file)
    system = System.load_from_file(path, device=args.device)
    system.set_logger(stdout=True)

    posterior = None
    calib_names = [v.name for v in system.inputs() if v.category == "calibration"]
    if args.posterior:
        chains, _ = read_mcmc_chain(args.posterior)
        posterior = chains.reshape(-1, chains.shape[-1])
        print(f"posterior predictive from {posterior.shape[0]} chain samples")

    if args.allocation:
        print_allocation(system)

    if args.data:
        return run_experimental_comparison(system, args, posterior, calib_names)

    results = {}
    for p_b in args.pressures:
        samples = system.sample_inputs(
            args.num_samples, seed=int(p_b * 1e8) % 2**31,
            use_pdf=["calibration", "nuisance"], nominal={"P_b": p_b}, constants=["operating"],
        )
        if posterior is not None:
            draws = posterior_draws(posterior, args.num_samples)
            for i, name in enumerate(calib_names[: draws.shape[1]]):
                samples[name] = torch.as_tensor(draws[:, i], dtype=torch.float32, device=system.device)
        outputs = system.predict(samples, use_model=None, qoi_ind=args.qois)
        pct = mc_percentiles(outputs)
        for k, v in outputs.items():
            results[f"P_b_{p_b:.2e}/{k}"] = np.asarray(to_numpy(v), dtype=float)
        line = " ".join(
            f"{q}={pct[q][50]:.4g}[{pct[q][5]:.4g},{pct[q][95]:.4g}]"
            for q in args.qois if q in pct and np.ndim(pct[q][50]) == 0
        )
        print(f"P_b={p_b:.1e}: {line}")

        if args.compare_model:
            truth = system.predict(samples, use_model="best", qoi_ind=args.qois)
            table = l2_error_table(outputs, truth, qois=args.qois)
            print("  surrogate vs model rel-L2:", {k: f"{v:.3e}" for k, v in table.items()})

    _save_npz(args.out, results)
    print(f"saved {args.out}")
    return results


if __name__ == "__main__":
    main()
