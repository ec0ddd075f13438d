"""The System layer: datasets, variables, components, systems and their JSON
configuration files."""

from hallthrusterpem_tpu_torch.core.component import Component
from hallthrusterpem_tpu_torch.core.dataset import COORDS_STR_ID, Dataset, to_model_dataset
from hallthrusterpem_tpu_torch.core.system import System
from hallthrusterpem_tpu_torch.core.variables import Compression, Distribution, Norm, Variable

__all__ = ["Dataset", "to_model_dataset", "COORDS_STR_ID", "Variable", "Distribution", "Norm",
           "Compression", "Component", "System"]
