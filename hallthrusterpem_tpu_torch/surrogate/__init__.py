"""Surrogates of the coupled system (the JAX package's ``surrogate/``): the
adaptive multi-fidelity sparse-grid (MISC) engine behind ``System.fit``, and the
system-level MLP ensemble (``surrogate.mlp``) with its failure-boundary tools
(``surrogate.domain``)."""

from hallthrusterpem_tpu_torch.surrogate.knots import leja_sequence, knots_for_level, barycentric_weights
from hallthrusterpem_tpu_torch.surrogate.interpolate import TensorInterpolant, eval_tensor, tensor_grid_points
from hallthrusterpem_tpu_torch.surrogate.misc import (
    combination_coefficients,
    candidate_neighbors,
    is_downward_closed,
)
from hallthrusterpem_tpu_torch.surrogate.component import ComponentSurrogate
from hallthrusterpem_tpu_torch.surrogate.train import fit_system, relative_l2

__all__ = [
    "leja_sequence",
    "knots_for_level",
    "barycentric_weights",
    "TensorInterpolant",
    "tensor_grid_points",
    "eval_tensor",
    "combination_coefficients",
    "candidate_neighbors",
    "is_downward_closed",
    "ComponentSurrogate",
    "fit_system",
    "relative_l2",
]
