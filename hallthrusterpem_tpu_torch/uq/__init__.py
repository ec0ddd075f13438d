"""Uncertainty quantification (the JAX package's ``uq``): Monte Carlo forward
UQ, DRAM and stretch-move MCMC, Sobol' sensitivity analysis, and the Hessian,
positive-definite, Laplace and MLE helpers of the calibration scripts.

The model or surrogate evaluations run batched on the system's device (one call
per ensemble proposal, per Saltelli design, per MC ensemble); the samplers'
bookkeeping and the statistics are numpy on the host.
"""

from hallthrusterpem_tpu_torch.surrogate.train import relative_l2
from hallthrusterpem_tpu_torch.uq.mcmc import (
    autocorrelation,
    dram,
    ess,
    integrated_autocorr_time,
    read_mcmc_chain,
    stretch,
)
from hallthrusterpem_tpu_torch.uq.montecarlo import mc_percentiles, run_mc
from hallthrusterpem_tpu_torch.uq.sobol import sobol_sa
from hallthrusterpem_tpu_torch.uq.utils import (
    approx_hess,
    is_positive_definite,
    laplace_approximation,
    nearest_positive_definite,
    normal_sample,
    run_mle,
)

__all__ = [
    "dram",
    "stretch",
    "autocorrelation",
    "integrated_autocorr_time",
    "ess",
    "read_mcmc_chain",
    "sobol_sa",
    "run_mc",
    "mc_percentiles",
    "approx_hess",
    "is_positive_definite",
    "nearest_positive_definite",
    "normal_sample",
    "laplace_approximation",
    "run_mle",
    "relative_l2",
]
