"""Sobol' sensitivity analysis of the PEM v0 over background pressure (the JAX
package's ``scripts/pem_v0/sobol.py``): S1/ST indices per QoI over the
calibration and nuisance inputs, operating conditions pinned, swept over
background pressures; samples that fail are left out of the estimators.

The Saltelli design's N*(d+2) rows go through the trained surrogate as one
batch on the system's device (``System.as_torch_fn``; an untrained system
evaluates ``predict(use_model=None)``, the true models, instead). Each input
column is drawn from its own ``torch.Generator``.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.pem_v0.sobol pem_v0_SPT-100_trained.json -n 5000 \\
      --out sobol.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from hallthrusterpem_tpu_torch.core.json_loader import find_latest_save
from hallthrusterpem_tpu_torch.core.system import System
from hallthrusterpem_tpu_torch.uq import sobol_sa

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("config_file")
parser.add_argument("--search", action="store_true", help="use the newest save under the config's directory")
parser.add_argument("-n", "--num_samples", type=int, default=5000)
parser.add_argument("--pressures", nargs="*", type=float, default=[3e-6, 1e-5, 3e-5, 5e-5, 8e-5])
parser.add_argument("--qois", nargs="*", default=["T", "I_d", "V_cc", "eta_a"])
parser.add_argument("--out", default=None, help="save the full S1/ST tables as a JSON file")
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def column_sampler(variables):
    """``sampler(n, seed) -> (n, d)`` float32 tensor: column ``i`` drawn from the
    pdf of ``variables[i]`` with a ``torch.Generator`` seeded from (seed, i)."""

    def sampler(n, seed):
        cols = []
        for i, v in enumerate(variables):
            key = int(np.random.SeedSequence((int(seed), i)).generate_state(1, np.uint64)[0])
            cols.append(v.sample(torch.Generator().manual_seed(key), (n,)))
        return torch.stack(cols, dim=-1)

    return sampler


def pressure_fn(system, names, p_b, qois):
    """``x (N, d) -> {qoi: (N,)}``: the swept inputs from ``x``, ``P_b`` at
    ``p_b``, every other input at its nominal, through the surrogate chain on
    the system's device; scalar outputs only."""
    try:
        model = system.as_torch_fn(training=False, qoi_ind=qois)
    except ValueError:  # no trained surrogate: the true models
        model = lambda batch: system.predict(batch, use_model=None, qoi_ind=qois)
    dev = system.device

    def fn(x):
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        n = x.shape[0]
        batch = {}
        for v in system.inputs():
            if v.name in names:
                batch[v.name] = x[:, names.index(v.name)]
            elif v.name == "P_b":
                batch[v.name] = torch.full((n,), p_b, dtype=torch.float32, device=dev)
            else:
                nom = v.nominal if v.nominal is not None else 0.5 * sum(v.get_domain())
                batch[v.name] = torch.full((n,), float(nom), dtype=torch.float32, device=dev)
        out = model(batch)
        return {q: out[q] for q in qois if q in out and out[q].dim() == 1}

    return fn


def main(argv=None):
    args = parser.parse_args(argv)
    path = find_latest_save(args.config_file) if args.search else Path(args.config_file)
    system = System.load_from_file(path, device=args.device)
    system.set_logger(stdout=True)

    # sensitivity over the calibration and nuisance inputs, operating conditions pinned
    sweep_vars = [v for v in system.inputs() if v.category in ("calibration", "nuisance")]
    names = [v.name for v in sweep_vars]
    d = len(names)
    sampler = column_sampler(sweep_vars)

    artifact = []
    for p_b in args.pressures:
        res = sobol_sa(pressure_fn(system, names, p_b, args.qois), sampler, n_samples=args.num_samples, d=d,
                       seed=int(p_b * 1e8) % 2**31)
        print(f"== P_b = {p_b:.1e} Torr")
        for qi, q in enumerate(res["qois"]):
            order = np.argsort(res["ST"][:, qi])[::-1][:5]
            tops = ", ".join(f"{names[i]}: S1={res['S1'][i, qi]:.3f} ST={res['ST'][i, qi]:.3f}"
                             for i in order)
            print(f"  {q}: {tops}")
        artifact.append({"P_b": p_b, "n_samples": args.num_samples, "params": names,
                         "qois": list(res["qois"]),
                         "S1": np.round(res["S1"], 5).tolist(),
                         "ST": np.round(res["ST"], 5).tolist()})

    if args.out:
        with open(args.out, "w") as fd:
            json.dump(artifact, fd, indent=1)
        print(f"saved {args.out}")
    return artifact


if __name__ == "__main__":
    main()
