"""Generate the compression data and the test set of a PEM system (the JAX
package's ``scripts/gen_data.py``).

Sample the inputs, run the true models (the thruster through the K-step kernel
on the card), mark NaN and IQR-outlier samples, pickle ``(samples, outputs)``
as numpy-only dicts (``compression.pkl``, ``test_set.pkl``: either package
reads them), compute the SVD compression maps of the field outputs and save a
compression-enabled System as ``<name>_compression.json`` plus its
``.state.pkl`` sidecar. The executor flags are accepted for parity and ignored:
each model runs as one batched call.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.gen_data pem_v0_SPT-100.json -c 200 -t 200 [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu_torch.core.dataset import as_numpy
from hallthrusterpem_tpu_torch.core.json_loader import load_system

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("config_file", help="System JSON (a path, or the name of a packaged configuration)")
parser.add_argument("-c", "--num_samples", type=int, default=200, help="compression samples")
parser.add_argument("-t", "--test_samples", type=int, default=200, help="test-set samples")
parser.add_argument("-e", "--executor", default="batch", help="(parity flag; one batched call always)")
parser.add_argument("-m", "--max_workers", type=int, default=None, help="(parity flag)")
parser.add_argument("-s", "--seed", type=int, default=0)
parser.add_argument("-o", "--output_dir", default=None)
parser.add_argument("--iqr_factor", type=float, default=1.5, help="IQR outlier threshold factor")
parser.add_argument("--discard_outliers", action="store_true",
                    help="discard IQR outliers in addition to NaN failures (default: warn about "
                         "outliers, discard only NaNs)")
parser.add_argument("--plots", action="store_true", help="save compression/test-set diagnostic plots")
parser.add_argument("--trim", default=None,
                    help="path to a trained domain classifier (trim_domain): reject-sample the prior "
                         "to the predicted-surviving domain")
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def save_plots(system, outputs, discard, out_dir):
    """Compression spectra and the kept/discarded histogram of each scalar
    output (matplotlib is imported here, not with the module)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for comp in system.components:
        for var in comp.outputs:
            c = var.compression
            if c is None or c.data_matrix is None:
                continue
            s = np.linalg.svd(np.asarray(c.data_matrix), compute_uv=False)
            fig, ax = plt.subplots(figsize=(4, 3))
            ax.semilogy(s / s[0], "-o", ms=3)
            ax.axvline(c.rank - 0.5, color="r", ls="--", label=f"rank {c.rank}")
            ax.set_xlabel("mode")
            ax.set_ylabel("normalized singular value")
            ax.set_title(var.name)
            ax.legend()
            fig.tight_layout()
            fig.savefig(out_dir / f"compression_{var.name}.png", dpi=110)
            plt.close(fig)

    scalars = [(k, np.asarray(v)) for k, v in outputs.items()
               if np.asarray(v).ndim == 1 and np.asarray(v).dtype.kind == "f"]
    if scalars:
        n = len(scalars)
        fig, axes = plt.subplots(1, n, figsize=(2.5 * n, 2.5), squeeze=False)
        for ax, (k, v) in zip(axes[0], scalars):
            good = v[~discard & np.isfinite(v)]
            bad = v[discard & np.isfinite(v)]
            ax.hist(good, bins=20, color="0.4", label="kept")
            if bad.size:
                ax.hist(bad, bins=20, color="r", alpha=0.5, label="discarded")
            ax.set_title(k, fontsize=8)
            ax.tick_params(labelsize=6)
        axes[0][0].legend(fontsize=6)
        fig.tight_layout()
        fig.savefig(out_dir / "test_set_outliers.png", dpi=110)
        plt.close(fig)


def filter_outputs(outputs: dict, iqr_factor: float = 1.5, skip: set | None = None):
    """NaN and IQR-outlier masks over the model outputs (numpy arrays).

    NaN and outlier rows are tracked apart, and only outputs are screened: a
    linear-space IQR on a log-uniform input would flag its upper decades. A
    field output marks an outlier when at least 75% of its points are.

    :param skip: names not screened (the system inputs)
    :returns: ``(nan_idx, outlier_idx)``, boolean arrays of shape ``(n,)``
    """
    skip = skip or set()
    n = None
    for v in outputs.values():
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.dtype.kind == "f":
            n = arr.shape[0]
            break
    if n is None:
        return np.zeros(0, dtype=bool), np.zeros(0, dtype=bool)
    nan_idx = np.zeros(n, dtype=bool)
    outlier_idx = np.zeros(n, dtype=bool)
    for key, v in outputs.items():
        arr = np.asarray(v)
        if (arr.dtype.kind != "f" or arr.ndim == 0 or arr.shape[0] != n
                or key.endswith("_coords") or key in skip or key == "model_cost"):
            continue
        flat = arr.reshape(n, -1)
        nan_idx |= ~np.isfinite(flat).all(axis=1)
        with np.errstate(invalid="ignore"):
            q1, q3 = np.nanpercentile(flat, 25, axis=0), np.nanpercentile(flat, 75, axis=0)
            iqr = q3 - q1
            out = (flat < q1 - iqr_factor * iqr) | (flat > q3 + iqr_factor * iqr)
        frac_needed = 0.75 if flat.shape[1] > 1 else 1.0
        outlier_idx |= out.mean(axis=1) >= frac_needed
    return nan_idx, outlier_idx


def generate_data(system, n, seed, tag, out_dir, iqr_factor=1.5, discard_outliers=False,
                  domain_filter=None):
    """Sample ``n`` inputs, label them with the true models, write
    ``<out_dir>/<tag>.pkl`` and return ``(samples, outputs, discard)`` as numpy."""
    samples = system.sample_inputs(n, seed=seed, use_pdf=["calibration", "nuisance"],
                                   domain_filter=domain_filter)
    outputs = as_numpy(system.predict(samples, use_model="best"))
    samples = as_numpy(samples)
    # numeric batch arrays only (no solver trees or paths)
    outputs = {k: v for k, v in outputs.items() if v.dtype.kind == "f" and v.ndim >= 1}
    nan_idx, outlier_idx = filter_outputs(outputs, iqr_factor, skip=set(samples))
    discard = (nan_idx | outlier_idx) if discard_outliers else nan_idx.copy()
    if outlier_idx.any():
        system.logger.warning("%s: %d/%d IQR outliers detected%s", tag, outlier_idx.sum(), n,
                              " (discarded)" if discard_outliers else " (kept; --discard_outliers to drop)")
    system.logger.info("%s: %d/%d samples kept (%d NaN-failed)", tag, n - discard.sum(), n, nan_idx.sum())
    with open(Path(out_dir) / f"{tag}.pkl", "wb") as fd:
        pickle.dump({"samples": samples, "outputs": outputs, "discard": discard,
                     "nan_idx": nan_idx, "outlier_idx": outlier_idx}, fd)
    return samples, outputs, discard


def process_compression(system, outputs, discard):
    """The SVD map of every compressed output, from its kept, normalized
    snapshots (and its coordinates, when the outputs carry them)."""
    keep = ~discard
    for comp in system.components:
        for var in comp.outputs:
            if var.compression is None or var.name not in outputs:
                continue
            snaps = np.asarray(outputs[var.name])[keep]
            coords_key = f"{var.name}_coords"
            if coords_key in outputs:
                c = np.asarray(outputs[coords_key])
                var.compression.coords = c[0] if c.ndim > 1 else c
            normed = np.asarray(var.normalize(snaps))
            var.compression.data_matrix = normed.T  # (grid, snapshots)
            var.compression.compute_map()
            system.logger.info("compression: %s rank %d", var.name, var.compression.rank)


def main(argv=None):
    args = parser.parse_args(argv)
    if args.num_samples < 2 or args.test_samples < 1:
        parser.error("need at least 2 compression samples and 1 test sample "
                     "(compression maps would be degenerate)")
    system = load_system(args.config_file, device=args.device)
    system.set_logger(stdout=True)
    out_dir = Path(args.output_dir) if args.output_dir else (Path(args.config_file).parent / "amisc_data")
    out_dir.mkdir(parents=True, exist_ok=True)
    system.root_dir = out_dir

    domain_filter = None
    if args.trim:
        from hallthrusterpem_tpu_torch.surrogate.domain import FailureClassifier, make_domain_filter

        domain_filter = make_domain_filter(FailureClassifier.load(args.trim), system)
        system.logger.info("trimming prior with domain classifier %s", args.trim)

    _, outputs, discard = generate_data(system, args.num_samples, args.seed, "compression", out_dir,
                                        args.iqr_factor, args.discard_outliers, domain_filter)
    generate_data(system, args.test_samples, args.seed + 1, "test_set", out_dir,
                  args.iqr_factor, args.discard_outliers, domain_filter)
    process_compression(system, outputs, discard)
    path = system.save_to_file(f"{system.name}_compression.json", out_dir)
    system.logger.info("saved %s", path)
    if args.plots:
        save_plots(system, outputs, discard, out_dir)
        system.logger.info("saved diagnostic plots in %s", out_dir)
    return path


if __name__ == "__main__":
    main()
