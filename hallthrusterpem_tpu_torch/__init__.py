"""PyTorch/CUDA port of the coupled Hall-thruster PEM (cathode -> 1-D discharge
solver -> plume), held against the JAX package ``hallthrusterpem_tpu``.

The port imports neither JAX nor the JAX package. Its entry points run on a
CUDA device unless the caller passes ``device="cpu"``; on a CUDA tensor the
discharge solver launches the hand-written kernel in
``models/thruster/csrc/kstep.cu``, on a CPU tensor its plain PyTorch version.
"""

from hallthrusterpem_tpu_torch.pem import CoupledPEM, default_coupled_inputs

__all__ = ["CoupledPEM", "default_coupled_inputs"]
