"""The pem_v0 analysis scripts: Bayesian calibration (``mcmc``), forward
Monte Carlo against experimental data (``monte_carlo``) and Sobol' sensitivity
analysis (``sobol``), with the shared data utilities of ``dataset_util``."""
