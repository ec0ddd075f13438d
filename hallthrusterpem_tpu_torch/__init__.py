"""PyTorch/CUDA port of the coupled Hall-thruster PEM (cathode -> 1-D discharge
solver -> plume), held against the JAX package ``hallthrusterpem_tpu``.

The port imports neither JAX nor the JAX package. Its entry points
(``CoupledPEM``, and the thruster component ``models.thruster.hallthruster_jl``)
run on a CUDA device unless the caller passes ``device="cpu"``; on a CUDA tensor
the discharge solver launches the hand-written kernels in ``models/thruster/csrc/``,
on a CPU tensor their plain PyTorch versions.
"""

__version__ = "0.5.0"

import logging as _logging

from hallthrusterpem_tpu_torch.pem import CoupledPEM, default_coupled_inputs


def get_logger(name: str) -> "_logging.Logger":
    """A named logger with one stream handler, at level WARNING when new (the
    reference's ``pem_core.get_logger``)."""
    logger = _logging.getLogger(name)
    if not logger.handlers:
        handler = _logging.StreamHandler()
        handler.setFormatter(_logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(_logging.WARNING)
    return logger


__all__ = ["CoupledPEM", "default_coupled_inputs", "get_logger", "__version__"]
