"""Restartable MCMC calibration driver (the JAX package's ``scripts/run_mcmc.py``).

DRAM calibration through the pem_v0 ``mcmc`` script, with a restart from an
earlier ``.npz`` chain: the start point is the chain's most probable sample
after half its rows are burnt, and the proposal covariance the scaled sample
covariance ``(2.38^2 / d) Cov``.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.run_mcmc trained.json --data spt100 --niter 20000 \\
      [--restart chain.npz] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from hallthrusterpem_tpu_torch.scripts.pem_v0 import mcmc as pem_mcmc
from hallthrusterpem_tpu_torch.uq import read_mcmc_chain

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("config_file")
parser.add_argument("--search", action="store_true")
parser.add_argument("--data", nargs="*", default=None)
parser.add_argument("--niter", type=int, default=10000)
parser.add_argument("--walkers", type=int, default=8)
parser.add_argument("--noise-std", type=float, default=0.02)
parser.add_argument("--file", default="dram_chain.npz")
parser.add_argument("--restart", default=None, help=".npz chain to resume from (start point + proposal cov)")
parser.add_argument("--use-model", default=None)
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def main(argv=None):
    args = parser.parse_args(argv)
    sub_args = [args.config_file, "--niter", str(args.niter), "--walkers", str(args.walkers),
                "--noise-std", str(args.noise_std), "--file", args.file]
    if args.search:
        sub_args.append("--search")
    if args.data:
        sub_args += ["--data"] + args.data
    if args.use_model:
        sub_args += ["--use-model", args.use_model]
    if args.device:
        sub_args += ["--device", args.device]
    if not args.restart:
        return pem_mcmc.main(sub_args)

    chains, logps = read_mcmc_chain(args.restart, burn_frac=0.5)
    flat = chains.reshape(-1, chains.shape[-1])
    x0 = flat[np.argmax(np.asarray(logps).reshape(-1))]
    cov0 = np.cov(flat.T) * (2.38**2 / flat.shape[1])
    print(f"restarting from {args.restart}: {flat.shape[0]} samples, x0={np.round(x0, 5)}")
    orig_dram = pem_mcmc.dram

    def dram_with_restart(logpdf, _x0, **kwargs):
        kwargs["cov0"] = cov0
        return orig_dram(logpdf, x0, **kwargs)

    pem_mcmc.dram = dram_with_restart
    try:
        return pem_mcmc.main(sub_args)
    finally:
        pem_mcmc.dram = orig_dram


if __name__ == "__main__":
    main()
