"""Fit a surrogate to a PEM system (the JAX package's ``scripts/fit_surr.py``).

Find the newest ``*_compression.json``, load the pickled test set beside it and
either train the system-level MLP ensemble on data the true models label
(``--surrogate mlp``, the default: labelling through the K-step kernel and
training on the card, TF32 off) or run the adaptive multi-fidelity MISC fit in
multi-, single- or both-fidelity modes (``--surrogate misc``), then save
``<name>_trained.json`` plus its ``.state.pkl`` sidecar beside the compression
save.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.fit_surr amisc_data/pem_v0_SPT-100_compression.json [--device cpu]
  python -m hallthrusterpem_tpu_torch.scripts.fit_surr pem_v0_SPT-100.json --search --surrogate misc -i 100
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu_torch.core.system import System

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("config_file", help="compression JSON (or a base config with --search)")
parser.add_argument("--search", action="store_true", help="search for the newest *_compression.json")
parser.add_argument("-i", "--max_iter", type=int, default=100)
parser.add_argument("-m", "--max_tol", type=float, default=1e-3)
parser.add_argument("-r", "--runtime_hr", type=float, default=None)
parser.add_argument("-N", "--num_refine", type=int, default=256)
parser.add_argument("-C", "--cache_interval", type=int, default=5)
parser.add_argument("-n", "--save_interval", type=int, default=20)
parser.add_argument("-f", "--fidelity", choices=["multi", "single", "both"], default="multi")
parser.add_argument("--targets", nargs="*", default=None)
parser.add_argument("-e", "--executor", default="batch", help="(parity flag)")
parser.add_argument("-c", "--max_workers", type=int, default=None, help="(parity flag)")
parser.add_argument("-d", "--discard_outliers", action="store_true",
                    help="drop IQR outliers from the test set (default: keep them, drop only NaN failures)")
parser.add_argument("--surrogate", choices=["misc", "mlp"], default="mlp",
                    help="surrogate backend: 'mlp', the system-level MLP ensemble (surrogate/mlp.py), "
                         "or 'misc', the adaptive multi-fidelity sparse-grid fit")
parser.add_argument("--mlp-samples", type=int, default=16384, help="training samples for --surrogate mlp")
parser.add_argument("--mlp-steps", type=int, default=6000)
parser.add_argument("--mlp-hidden", type=int, nargs="*", default=[256, 256, 256])
parser.add_argument("--mlp-ensemble", type=int, default=8)
parser.add_argument("--mlp-chunk", type=int, default=1024, help="eval chunk for resumable data generation")
parser.add_argument("--mlp-seed", type=int, default=7)
parser.add_argument("--mlp-log-outputs", nargs="*", default=None,
                    help="scalar outputs regressed in log10 space for --surrogate mlp (default: chosen by "
                         "their p99/p1 range; an empty list disables log targets)")
parser.add_argument("--trim", default=None,
                    help="domain classifier pickle (trim_domain): restrict --surrogate mlp training-data "
                         "sampling to the surviving domain")
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def find_config(base: Path) -> Path:
    """The newest ``*_compression.json`` under the config's directory tree."""
    root = base if base.is_dir() else base.parent
    candidates = sorted(root.rglob("*_compression.json"), key=lambda p: p.stat().st_mtime)
    if not candidates:
        raise FileNotFoundError(f"No *_compression.json under {root}; run gen_data first")
    return candidates[-1]


def load_test_set(config_path: Path, discard_outliers: bool = False):
    """``(xt, yt)`` numpy dicts from ``test_set.pkl`` beside the config (None if
    there is none): NaN failures always dropped, IQR outliers only with
    ``discard_outliers`` (a pickle with only the combined mask drops that)."""
    pkl = Path(config_path).parent / "test_set.pkl"
    if not pkl.exists():
        return None
    with open(pkl, "rb") as fd:
        d = pickle.load(fd)
    if "nan_idx" in d:
        drop = d["nan_idx"] | (d["outlier_idx"] if discard_outliers else False)
    else:
        drop = d["discard"]
    keep = ~drop
    xt = {k: np.asarray(v)[keep] for k, v in d["samples"].items()}
    yt = {}
    for k, v in d["outputs"].items():
        arr = np.asarray(v)
        if k.endswith("_coords") or arr.dtype.kind != "f" or arr.ndim < 1 or arr.shape[0] != keep.size:
            continue
        yt[k] = arr[keep]
    return xt, yt


def train_surrogate(system, fidelity: str, args, test_set):
    """MISC fits: multi-fidelity, single-fidelity (each component's
    ``model_fidelity`` emptied) or both; each resumes from the training cache
    of an interrupted run. Returns the history of each mode."""
    histories = {}
    modes = ["multi", "single"] if fidelity == "both" else [fidelity]
    saved_alpha = {c.name: c.model_fidelity for c in system.components}
    for mode in modes:
        system.clear()
        for comp in system.components:
            comp.model_fidelity = () if mode == "single" else saved_alpha[comp.name]
        if system.root_dir is not None:
            cache_pkl = Path(system.root_dir) / "cache" / f"{system.name}_training_cache.pkl"
            if cache_pkl.exists():
                n = system.load_training_cache(cache_pkl)
                system.logger.info("reloaded %d cached model evals from %s", n, cache_pkl)
        system.fit(
            targets=args.targets,
            max_iter=args.max_iter,
            max_tol=args.max_tol,
            runtime_hr=args.runtime_hr,
            num_refine=args.num_refine,
            save_interval=args.save_interval,
            cache_interval=args.cache_interval,
            test_set=test_set,
            estimate_bounds=True,
            update_bounds=True,
        )
        histories[mode] = list(system.train_history)
    return histories


def train_mlp(system, args, test_set, config_path: Path):
    """The system-level MLP ensemble: label (or resume) a prior sample, train on
    every labelled cache in the run directory, print the held-out rel-L2 per
    QoI. Returns ``(surrogate, errors)``."""
    from hallthrusterpem_tpu_torch.surrogate.mlp import MLPSurrogate, generate_training_data, load_training_caches

    domain_filter = None
    if args.trim:
        from hallthrusterpem_tpu_torch.surrogate.domain import FailureClassifier, make_domain_filter

        domain_filter = make_domain_filter(FailureClassifier.load(args.trim), system)
    cache = Path(config_path).parent / f"{system.name}_mlp_train_data.pkl"
    generate_training_data(system, args.mlp_samples, seed=args.mlp_seed, chunk=args.mlp_chunk,
                           cache_path=cache, domain_filter=domain_filter)
    # every labelled cache of the run directory (gen_mlp_data adds per-seed ones)
    samples, outputs = load_training_caches(Path(config_path).parent, system)
    log_outputs = "auto" if args.mlp_log_outputs is None else tuple(args.mlp_log_outputs)
    surr = MLPSurrogate(system, hidden=tuple(args.mlp_hidden), ensemble=args.mlp_ensemble,
                        seed=args.mlp_seed, log_outputs=log_outputs)
    info = surr.fit(samples, outputs, steps=args.mlp_steps)
    system.system_surrogate = surr
    print(f"=== mlp: {info['n_train']} train samples ({info['fail_frac']:.1%} solver failures), "
          f"val rmse {info.get('val_rmse', float('nan')):.4f}, "
          f"fail-classifier acc {info.get('val_fail_acc', float('nan')):.3f}")
    errors = {}
    if test_set is not None:
        errors = surr.test_errors(*test_set, targets=args.targets)
        for k, v in sorted(errors.items()):
            print(f"  test rel-L2 {k}: {v:.4f}")
    return surr, errors


def main(argv=None):
    """Returns the path of the trained save."""
    args = parser.parse_args(argv)
    path = Path(args.config_file)
    if args.search or not path.name.endswith("_compression.json"):
        path = find_config(path)
    system = System.load_from_file(path, device=args.device)
    system.set_logger(stdout=True)
    test_set = load_test_set(path, discard_outliers=args.discard_outliers)

    if args.surrogate == "mlp":
        train_mlp(system, args, test_set, path)
        return system.save_to_file(f"{system.name}_trained.json", path.parent)

    histories = train_surrogate(system, args.fidelity, args, test_set)
    for mode, hist in histories.items():
        cost_alloc, model_cost, overhead, evals = system.get_allocation()
        print(f"=== {mode}-fidelity: {len(hist)} iterations, "
              f"model cost {model_cost:.1f}s, overhead {overhead:.1f}s")
        for h in hist[-5:]:
            print(f"  iter {h['iteration']}: {h['component']} a={h['alpha']} b={h['beta']} "
                  f"surplus={h['error_indicator']:.3e} test={h['test_error']}")
    return system.save_to_file(f"{system.name}_trained.json", path.parent)


if __name__ == "__main__":
    main()
