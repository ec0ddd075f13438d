"""Plotting (the JAX package's ``viz.py``): 1-D slice diagnostics, cost-allocation
bars, error-vs-cost curves, and the ``ax_default``/``ndscatter`` helpers of the
analysis scripts.

The system is evaluated on its own device; only the drawing runs on the host.
matplotlib is imported inside each function, with the headless Agg backend, so
that every module of the port imports where matplotlib is absent (the machine
with the card has none). Each function returns ``(fig, ax)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from hallthrusterpem_tpu_torch.core.dataset import to_numpy

__all__ = ["ax_default", "plot_slice", "plot_allocation", "plot_error_vs_cost", "ndscatter"]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def ax_default(ax=None, xlabel: str = "", ylabel: str = "", legend: bool = False):
    """Default axis styling: labels, a light grid, optionally the legend."""
    if ax is None:
        _, ax = _pyplot().subplots()
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    if legend:
        ax.legend()
    return ax


def plot_slice(
    system,
    inputs: Optional[Sequence[str]] = None,
    outputs: Optional[Sequence[str]] = None,
    num_steps: int = 15,
    show_model: Sequence[str] = ("best",),
    nominal: Optional[dict] = None,
    random_walk: bool = False,
    executor=None,
    save_path=None,
):
    """1-D slice diagnostics: sweep each input over its domain (the others at
    nominal, or with ``random_walk`` along random lines through their domains)
    and plot each uncompressed output, true model against surrogate."""
    plt = _pyplot()
    in_vars = [v for v in system.inputs() if inputs is None or v.name in inputs]
    out_names = [v.name for v in system.outputs() if (outputs is None or v.name in outputs)
                 and v.compression is None]
    nominal = nominal or {}

    fig, axes = plt.subplots(
        len(out_names), len(in_vars), figsize=(3 * len(in_vars), 2.5 * len(out_names)),
        squeeze=False,
    )
    rng = np.random.default_rng(0)
    for j, var in enumerate(in_vars):
        dom = var.get_domain()
        sweep = np.linspace(dom[0], dom[1], num_steps)
        base = {}
        for v in system.inputs():
            if random_walk and v.name != var.name and v.get_domain() is not None:
                d2 = v.get_domain()
                a, b = rng.uniform(d2[0], d2[1], 2)
                base[v.name] = np.linspace(a, b, num_steps)
                continue
            nom = nominal.get(v.name, v.nominal)
            if nom is None:
                d2 = v.get_domain()
                nom = 0.5 * (d2[0] + d2[1])
            base[v.name] = np.full(num_steps, float(nom))
        base[var.name] = sweep

        results = {}
        if any(m in ("best", "truth") for m in show_model):
            results["model"] = system.predict(base, use_model="best")
        if "worst" in show_model:
            results["model (lowest fidelity)"] = system.predict(base, use_model="worst")
        if "surrogate" in show_model or any(c.surrogate is not None for c in system.components):
            results["surrogate"] = system.predict(base, use_model=None, training=True)

        for i, out_name in enumerate(out_names):
            ax = axes[i][j]
            for label, res in results.items():
                if out_name in res:
                    y = np.asarray(to_numpy(res[out_name]), dtype=float)
                    if y.ndim == 1:
                        ax.plot(sweep, y, "-" if label == "model" else "--", label=label)
            if i == len(out_names) - 1:
                ax.set_xlabel(var.get_tex(units=True))
            if j == 0:
                ax.set_ylabel(out_name)
            ax.grid(True, alpha=0.3)
    axes[0][0].legend(fontsize=7)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig, axes


def plot_allocation(system, save_path=None):
    """Horizontal bars of the model cost spent per component and fidelity."""
    plt = _pyplot()
    cost_alloc, model_cost, overhead, _ = system.get_allocation()
    fig, ax = plt.subplots(figsize=(6, 4))
    labels, costs = [], []
    for comp, alphas in cost_alloc.items():
        for alpha, cost in alphas.items():
            labels.append(f"{comp} a={alpha}")
            costs.append(cost)
    if costs:
        ax.barh(labels, costs)
    ax.set_xlabel("model cost (s)")
    ax.set_title(f"total model {model_cost:.1f}s, overhead {overhead:.1f}s")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig, ax


def plot_error_vs_cost(train_history, targets=None, save_path=None):
    """Relative test error against cumulative model evaluations, per output."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    cum_evals = np.cumsum([h.get("num_evals", 0) for h in train_history])
    all_targets = targets or sorted({k for h in train_history for k in h.get("test_error", {})})
    for t in all_targets:
        errs = [h["test_error"].get(t, np.nan) for h in train_history]
        ax.loglog(np.maximum(cum_evals, 1), errs, "-o", ms=3, label=t)
    ax.set_xlabel("cumulative model evaluations")
    ax.set_ylabel("relative L2 test error")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig, ax


def ndscatter(samples, labels: Optional[Sequence[str]] = None, subplot_size: float = 1.5, save_path=None):
    """Corner (pairs) plot of MCMC samples: histograms on the diagonal, pairwise
    scatter below it."""
    plt = _pyplot()
    x = np.asarray(to_numpy(samples))
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
    d = x.shape[1]
    fig, axes = plt.subplots(d, d, figsize=(subplot_size * d, subplot_size * d), squeeze=False)
    for i in range(d):
        for j in range(d):
            ax = axes[i][j]
            if i == j:
                ax.hist(x[:, i], bins=40, color="0.4")
            elif i > j:
                ax.plot(x[:, j], x[:, i], ".", ms=1, alpha=0.3)
            else:
                ax.axis("off")
            if labels is not None:
                if i == d - 1 and j <= i:
                    ax.set_xlabel(labels[j], fontsize=7)
                if j == 0 and i > 0:
                    ax.set_ylabel(labels[i], fontsize=7)
            ax.tick_params(labelsize=6)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig, axes
