"""Fit a solver-failure-boundary classifier for prior-domain trimming (the JAX
package's ``scripts/trim_domain.py``).

The pem_v0 prior box holds corners where the solver fails (a quenched
discharge, a guard-masked blow-up), whose samples the workflow discards as
NaNs. This script fits the quadratic logistic classifier of
:mod:`hallthrusterpem_tpu_torch.surrogate.domain` to labelled dataset pickles
(``gen_data``'s ``test_set.pkl``/``compression.pkl`` or an MLP training-data
cache, of either package), reports its held-out accuracy and failure recall and
saves it for ``gen_data --trim`` / ``fit_surr --trim``.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.trim_domain pem_v0_SPT-100.json amisc_data/test_set.pkl \\
      [-o classifier.pkl] [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu_torch.core.json_loader import load_system
from hallthrusterpem_tpu_torch.surrogate.domain import FailureClassifier, failure_mask

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("config_file", help="System JSON (base or compression)")
parser.add_argument("data", nargs="+", help="labelled dataset pickle(s): gen_data test_set/compression pkl "
                                            "or *_mlp_train_data.pkl")
parser.add_argument("-o", "--output", default=None, help="output classifier pickle")
parser.add_argument("--threshold", type=float, default=0.5, help="P(fail) above which a sample is rejected")
parser.add_argument("--steps", type=int, default=3000)
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def load_labeled(path: Path):
    """``(samples, outputs)`` of a gen_data pickle, or ``(None, outputs)`` of an
    MLP training-data cache (whose inputs ride along inside its outputs)."""
    with open(path, "rb") as fd:
        d = pickle.load(fd)
    if "samples" in d:
        return d["samples"], d["outputs"]
    if "outputs" in d:
        return None, d["outputs"]
    raise ValueError(f"{path}: not a labeled dataset pickle")


def main(argv=None):
    """Returns ``(classifier, path it was saved to)``."""
    args = parser.parse_args(argv)
    system = load_system(args.config_file, device=args.device)
    system.set_logger(stdout=True)

    in_names = [v.name for v in system.inputs()]
    X_all, fail_all = [], []
    for data_path in args.data:
        samples, outputs = load_labeled(Path(data_path))
        if samples is None:
            samples = {k: outputs[k] for k in in_names if k in outputs}
        fail = failure_mask(outputs, skip=set(samples))
        X_all.append(FailureClassifier(in_names).pack(samples, system=system))
        fail_all.append(fail)
        system.logger.info("%s: %d samples, %d failures", data_path, fail.size, fail.sum())

    X = np.concatenate(X_all, axis=0)
    fail = np.concatenate(fail_all, axis=0)
    clf = FailureClassifier(in_names, threshold=args.threshold)
    info = clf.fit(X, fail, steps=args.steps)
    print(f"fitted on {fail.size} samples ({fail.mean():.1%} failures): "
          f"val acc {info.get('val_acc', float('nan')):.3f}, "
          f"fail recall {info.get('val_fail_recall', float('nan')):.3f}")

    out = Path(args.output) if args.output else Path(args.data[0]).parent / "domain_classifier.pkl"
    clf.save(out)
    print(f"saved {out}")
    return clf, out


if __name__ == "__main__":
    main()
