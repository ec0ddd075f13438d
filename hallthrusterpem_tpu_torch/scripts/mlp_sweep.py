"""MLP-surrogate hyper-parameter sweep on cached training data (the JAX
package's ``scripts/mlp_sweep.py``).

Loads every labelled training-data cache of a run directory once
(``<name>_mlp_train_data*.pkl``, either package's, as ``gen_mlp_data`` writes
them) and fits a grid of ensemble variants on the system's device, each scored
by its held-out rel-L2 per QoI on the run's ``test_set.pkl``; the score of a
variant is the sum of its T, I_d, u_ion and j_ion rel-L2. The records go to a
JSON file (``runs/h100/mlp_sweep.json`` by default: never into a TPU run's
directory); with ``--save-best`` the best ensemble is saved as the trained
system (JSON plus its ``.state.pkl`` sidecar) next to that file.

The system is the run's ``--config`` (``<dir>/pem_v0_SPT-100_compression.json``
by default; a bare file name missing from the run directory is the packaged
copy, r5's compression, as for a run the JAX package saved).

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.mlp_sweep --dir amisc_data [--variants base6k wide512]
      [-o amisc_data/mlp_sweep.json] [--save-best] [--device cpu]
  python -m hallthrusterpem_tpu_torch.scripts.mlp_sweep      # runs/r5/surr, once its caches are there
"""

from __future__ import annotations

import argparse
import json
import pickle
import time
from pathlib import Path

import numpy as np

SURR_DIR = Path("runs/r5/surr")

VARIANTS = [
    {"name": "base6k", "hidden": (256, 256, 256), "steps": 6000},
    {"name": "long20k", "hidden": (256, 256, 256), "steps": 20000},
    {"name": "wide512", "hidden": (512, 512, 512), "steps": 20000},
    {"name": "deep384", "hidden": (384, 384, 384, 384), "steps": 20000},
    {"name": "wide512_wd1e-4", "hidden": (512, 512, 512), "steps": 20000,
     "weight_decay": 1e-4},
    {"name": "wide512_b4096", "hidden": (512, 512, 512), "steps": 20000, "batch": 4096},
    # the round-4 final-fit candidates (96k samples)
    {"name": "deep384_30k", "hidden": (384, 384, 384, 384), "steps": 30000},
    {"name": "deep512_30k", "hidden": (512, 512, 512, 512), "steps": 30000},
    {"name": "deep384_30k_e16", "hidden": (384, 384, 384, 384), "steps": 30000,
     "ensemble": 16},
]

TARGETS = ["T", "I_d", "I_B0", "u_ion", "j_ion", "eta_m", "eta_v", "V_cc"]
#: the QoIs whose rel-L2 sum scores a variant (1.0 for a missing one)
SCORED = ("T", "I_d", "u_ion", "j_ion")


def load_test_set(path) -> tuple[dict, dict]:
    """The held-out ``(samples, outputs)`` of a ``test_set.pkl``, its discarded rows dropped."""
    with open(path, "rb") as fd:
        test = pickle.load(fd)
    keep = ~np.asarray(test["discard"]) if test.get("discard") is not None else slice(None)
    xt = {k: np.asarray(v)[keep] for k, v in test["samples"].items()}
    yt = {k: np.asarray(v)[keep] for k, v in test["outputs"].items()}
    return xt, yt


def score(errors: dict) -> float:
    return sum(errors.get(q, 1.0) for q in SCORED)


def main(argv=None):
    """Returns the sweep's records and the best variant's ``(name, surrogate)``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--save-best", action="store_true")
    parser.add_argument("--dir", default=str(SURR_DIR), help="surrogate run directory")
    parser.add_argument("--config", default="pem_v0_SPT-100_compression.json",
                        help="System JSON with the compression maps, in --dir or packaged")
    parser.add_argument("--variants", nargs="*", default=None)
    parser.add_argument("-o", "--output", default="runs/h100/mlp_sweep.json")
    parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")
    args = parser.parse_args(argv)

    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.surrogate.mlp import MLPSurrogate, load_training_caches

    surr_dir = Path(args.dir)
    config = surr_dir / args.config if (surr_dir / args.config).exists() else args.config
    system = load_system(config, device=args.device)
    system.set_logger(stdout=True)
    samples, outputs = load_training_caches(surr_dir, system)
    xt, yt = load_test_set(surr_dir / "test_set.pkl")

    results = []
    best = None
    chosen = [v for v in VARIANTS if args.variants is None or v["name"] in args.variants]
    for spec in chosen:
        spec = dict(spec)
        name = spec.pop("name")
        hidden = spec.pop("hidden")
        ensemble = spec.pop("ensemble", 8)
        t0 = time.time()
        surr = MLPSurrogate(system, hidden=hidden, ensemble=ensemble, seed=7)
        info = surr.fit(samples, outputs, verbose=False, **spec)
        errors = surr.test_errors(xt, yt, targets=TARGETS)
        wall = time.time() - t0
        rec = {"name": name, "hidden": list(hidden), "ensemble": ensemble, **spec,
               "val_rmse": info.get("val_rmse"), "wall_s": round(wall, 1),
               "rel_l2": {k: round(float(v), 4) for k, v in errors.items()}}
        results.append(rec)
        s = score(errors)
        print(f"{name}: val_rmse={info.get('val_rmse'):.3f} "
              f"{ {k: round(float(v), 3) for k, v in sorted(errors.items())} } "
              f"[{wall:.0f}s]", flush=True)
        if best is None or s < best[0]:
            best = (s, name, surr)

    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as fd:
        json.dump(results, fd, indent=1)
    print(f"saved {out_path}; best: {best[1]}")

    if args.save_best:
        system.system_surrogate = best[2]
        saved = system.save_to_file("pem_v0_SPT-100_trained.json", out_path.parent)
        print(f"saved trained system ({best[1]}) -> {saved}")
    return results, best[1:]


if __name__ == "__main__":
    main()
