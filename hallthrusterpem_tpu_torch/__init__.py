"""PyTorch/CUDA port of the coupled Hall-thruster PEM (cathode -> 1-D discharge
solver -> plume), held against the JAX package ``hallthrusterpem_tpu``.

The port imports neither JAX nor the JAX package. Its entry points
(``CoupledPEM``, and the thruster component ``models.thruster.hallthruster_jl``)
run on a CUDA device unless the caller passes ``device="cpu"``; on a CUDA tensor
the discharge solver launches the hand-written kernels in ``models/thruster/csrc/``,
on a CPU tensor their plain PyTorch versions.
"""

from hallthrusterpem_tpu_torch.pem import CoupledPEM, default_coupled_inputs

__all__ = ["CoupledPEM", "default_coupled_inputs"]
