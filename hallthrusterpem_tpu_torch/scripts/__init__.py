"""Command-line analysis scripts of the port, run as modules
(``python -m hallthrusterpem_tpu_torch.scripts.pem_v0.mcmc ...``): the pem_v0
scripts, the restartable MCMC driver ``run_mcmc`` and the chain continuation
``continue_mcmc``."""
