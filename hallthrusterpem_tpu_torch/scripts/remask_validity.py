"""Re-apply the thruster wrapper's discharge-current validity guard to cached
labelled datasets (MLP training caches and the test set) in place (the JAX
package's ``scripts/remask_validity.py``).

The guard (a time-averaged I_d outside [0.2, 8] e mdot_a / m_i is a failed
solve, a NaN row) came after data labelled by older versions. The labels stay;
this pass recomputes the failure masks so that training and evaluation see the
rows the wrapper now rejects, without labelling anything again. The pickles stay
numpy-only, readable by either package.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.remask_validity amisc_data [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from hallthrusterpem_tpu_torch.constants import FUNDAMENTAL_CHARGE, atomic_mass_kg

MI = atomic_mass_kg("Xenon")


def validity_mask(i_d, mdot_a):
    """True for the finite rows the wrapper's quasi-steady-average guard rejects."""
    i_eq = FUNDAMENTAL_CHARGE * np.asarray(mdot_a, dtype=float) / MI
    i_d = np.asarray(i_d, dtype=float)
    with np.errstate(invalid="ignore"):
        return np.isfinite(i_d) & ((i_d < 0.2 * i_eq) | (i_d > 8.0 * i_eq))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("run_dir", nargs="?", default="amisc_data")
    parser.add_argument("--config", default="pem_v0_SPT-100_compression.json",
                        help="file name of the compression save in run_dir (its inputs are left unmasked)")
    parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")
    args = parser.parse_args(argv)
    run_dir = Path(args.run_dir)

    from hallthrusterpem_tpu_torch.core.system import System

    system = System.load_from_file(run_dir / args.config, device=args.device)
    in_names = {v.name for v in system.inputs()}

    for path in sorted(run_dir.glob("*mlp_train_data*.pkl")):
        with open(path, "rb") as fd:
            cache = pickle.load(fd)
        out = cache["outputs"]
        n = cache.get("done", len(np.asarray(out["I_d"])))
        bad = validity_mask(np.asarray(out["I_d"])[:n], np.asarray(out["mdot_a"])[:n])
        if not bad.any():
            print(f"{path.name}: no rows to remask")
            continue
        for key, val in out.items():
            val = np.asarray(val)
            if val.dtype.kind != "f" or val.ndim < 1 or val.shape[0] < n:
                continue
            # the sampled input columns ride along inside the outputs: they stay,
            # as do the coordinates and the cost bookkeeping
            if key in in_names or key.endswith("_coords") or key == "model_cost":
                continue
            mask = bad.reshape(bad.shape + (1,) * (val.ndim - 1))
            val = val.copy()
            val[:n] = np.where(np.broadcast_to(mask, val[:n].shape), np.nan, val[:n])
            out[key] = val
        with open(path, "wb") as fd:
            pickle.dump(cache, fd)
        print(f"{path.name}: NaN-masked {int(bad.sum())}/{n} runaway rows")

    ts_path = run_dir / "test_set.pkl"
    if ts_path.exists():
        with open(ts_path, "rb") as fd:
            test = pickle.load(fd)
        bad = validity_mask(test["outputs"]["I_d"], test["samples"]["mdot_a"])
        for key in ("discard", "nan_idx"):
            if key in test and test[key] is not None:
                test[key] = np.asarray(test[key]) | bad
        for key, val in test["outputs"].items():
            val = np.asarray(val)
            if val.dtype.kind != "f" or val.ndim < 1 or val.shape[0] != bad.shape[0]:
                continue
            mask = bad.reshape(bad.shape + (1,) * (val.ndim - 1))
            test["outputs"][key] = np.where(np.broadcast_to(mask, val.shape), np.nan, val)
        with open(ts_path, "wb") as fd:
            pickle.dump(test, fd)
        print(f"test_set.pkl: marked {int(bad.sum())} runaway rows as failures")


if __name__ == "__main__":
    main()
