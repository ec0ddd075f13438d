"""Solver "installation": build the discharge solver's CUDA kernels ahead of
first use, then smoke-run the coupled PEM at each fidelity (the JAX package's
``scripts/install_solver.py``, which warms XLA's compilation cache instead).

The kernels (``models/thruster/csrc`` and the plume's ``models/csrc/plume.cu``)
are built with ``nvcc`` for ``sm_90a``
into ``build/torch_kernels/`` at the root of the checkout, one process per
source, all started together; a build that fails raises (there is no fallback).
Each library's path and build seconds are printed, then the launches and the
wall time of one ``CoupledPEM`` call at each ``--fidelities`` entry.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.install_solver [--fidelities "(0, 0)" "(2, 2)"] [--batch 64]
  python -m hallthrusterpem_tpu_torch.scripts.install_solver --device cpu   # no build: the plain path
"""

from __future__ import annotations

import argparse
import ast
import time

import torch

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("-y", "--yes", action="store_true", help="(parity flag; no prompts here)")
parser.add_argument("--cache-dir", default=None,
                    help="(parity flag; the kernels build under build/torch_kernels/ of the checkout)")
parser.add_argument("--fidelities", nargs="*", default=["(0, 0)", "(1, 1)", "(2, 2)"])
parser.add_argument("--batch", type=int, default=64)
parser.add_argument("--duration", type=float, default=2e-5, help="simulated seconds of each smoke run")
parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")


def main(argv=None):
    """Returns ``{"build": {kernel: {path, seconds, cached}}, "fidelities":
    [{fidelity, cells, ncharge, wall_s, kstep_launches, finite}]}``."""
    args = parser.parse_args(argv)
    from hallthrusterpem_tpu_torch import kernel_build
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.pem import CoupledPEM, default_coupled_inputs
    from hallthrusterpem_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    rec = {"build": {}, "fidelities": []}
    if device.type == "cuda":
        kernel_build.build_all()
        for name, info in kernel_build.build_info.items():
            rec["build"][name] = {k: info[k] for k in ("path", "seconds", "cached")}
            print(f"{name}: {info['path']} built in {info['seconds']:.1f}s"
                  + (" (already built)" if info["cached"] else ""))
    else:
        print(f"device {device}: no kernels to build (the plain PyTorch path)")

    for fid in args.fidelities:
        alpha = tuple(ast.literal_eval(fid))
        pem = CoupledPEM(thruster="SPT-100", model_fidelity=alpha, duration=args.duration, device=device)
        inputs = default_coupled_inputs(args.batch, device=device)
        _kernels.reset_counts()
        t0 = time.perf_counter()
        out = pem(inputs)
        finite = int(torch.isfinite(out["T"]).sum())  # waits for the solve
        wall = time.perf_counter() - t0
        launches = _kernels.launch_counts["kstep"]
        rec["fidelities"].append({"fidelity": list(alpha), "cells": pem.cfg.num_cells, "ncharge": pem.cfg.ncharge,
                                  "wall_s": wall, "kstep_launches": launches, "finite": finite})
        print(f"fidelity {alpha}: {pem.cfg.num_cells} cells, {pem.cfg.ncharge} charge states, smoke-ran B="
              f"{args.batch} in {wall:.1f}s ({launches} kstep launches, {finite} finite rows)")
    print("solver kernels ready" if device.type == "cuda" else "plain solver ready")
    return rec


if __name__ == "__main__":
    main()
