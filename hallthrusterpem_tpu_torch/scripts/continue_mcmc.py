"""Continue a stretch-ensemble chain from its last recorded ensemble (the JAX
package's ``scripts/continue_mcmc.py``).

The ``.npz`` chain appends, so a continuation extends the effective sample
size without a new burn-in: the new segment starts exactly where the stored
chain ended (``uq.stretch`` does not write its starting ensemble again). The
posterior is the device posterior of ``mcmc.py`` on a trained surrogate, the
spt100 data and the QoIs V_cc, T, I_d, u_ion and j_ion.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.continue_mcmc chain.npz --config trained.json \\
      [--niter 20000] [--noise-samples 16] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from hallthrusterpem_tpu_torch.scripts.pem_v0 import mcmc as M
from hallthrusterpem_tpu_torch.uq import integrated_autocorr_time, read_mcmc_chain, stretch

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("chain")
parser.add_argument("--config", required=True, help="the trained system (JSON + .state.pkl sidecar)")
parser.add_argument("--niter", type=int, default=20000)
parser.add_argument("--noise-samples", type=int, default=16)
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def main(argv=None):
    args = parser.parse_args(argv)
    m_args = M.parser.parse_args([args.config, "--data", "spt100", "--walkers", "64",
                                  "--noise-samples", str(args.noise_samples), "--file", args.chain,
                                  "--qois", "V_cc", "T", "I_d", "u_ion", "j_ion", "--sampler", "stretch"]
                                 + (["--device", args.device] if args.device else []))
    system = M.load_system(m_args)
    calib = [v for v in system.inputs() if v.category == "calibration"]
    names = [v.name for v in calib]
    ops, obs, sig, fields = M.build_dataset(system, m_args)
    log_posterior, _ = M.build_device_posterior(system, m_args, calib, names, ops, obs, sig, fields)

    stored, _ = read_mcmc_chain(args.chain, burn_frac=0.0, clean=False)
    x_last = stored[-1]  # (W, d)
    print(f"continuing from ensemble state {x_last.shape} in {args.chain}")

    samples, logps, acc = stretch(log_posterior, x_last, niter=args.niter, n_walkers=x_last.shape[0],
                                  filename=args.chain, progress=True)
    print(f"acceptance: {acc:.3f}")
    s, _ = read_mcmc_chain(args.chain, burn_frac=0.0, clean=False)
    burn = s.shape[0] // 4
    taus = []
    for p in range(s.shape[-1]):
        per_w = [integrated_autocorr_time(s[burn:, w, p]) for w in range(0, s.shape[1], 8)]
        taus.append(float(np.mean(per_w)))
    n_eff = (s.shape[0] - burn) * s.shape[1] / np.maximum(taus, 1.0)
    print("total chain:", s.shape, "per-walker IAC min/med/max:",
          round(min(taus)), round(float(np.median(taus))), round(max(taus)))
    print("honest ESS per param: min", int(n_eff.min()), "median", int(np.median(n_eff)))
    return samples, logps, acc


if __name__ == "__main__":
    main()
