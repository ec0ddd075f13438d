"""Command-line scripts of the port, run as modules
(``python -m hallthrusterpem_tpu_torch.scripts.gen_data ...``): the workflow
(``gen_data``, ``fit_surr``, ``plot_slice``), the surrogate-campaign tools
(``gen_mlp_data``, ``trim_domain``, ``remask_validity``, ``surr_report``),
``validate_solver``, ``debug``, ``install_solver``, the pem_v0 analysis scripts,
the restartable MCMC calibration ``run_mcmc`` and the chain continuation
``continue_mcmc``."""
