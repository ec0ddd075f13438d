"""Command-line analysis scripts of the port, run as modules
(``python -m hallthrusterpem_tpu_torch.scripts.pem_v0.mcmc ...``)."""
