"""Dataset: the data-exchange type of the System layer (the JAX package's
``core/dataset.py``), a ``dict[str, tensor]``.

A field quantity (a profile such as ``u_ion(z)``) carries its grid in a companion
entry named ``"{var}_coords"``.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

Dataset = Dict[str, torch.Tensor]

#: suffix of a field quantity's coordinate entry: "{var}" + COORDS_STR_ID
COORDS_STR_ID = "_coords"


def is_coords_key(key: str) -> bool:
    return key.endswith(COORDS_STR_ID)


def base_var_of_coords(key: str) -> str:
    return key[: -len(COORDS_STR_ID)]


def stack_dataset(ds: Dataset, names: Iterable[str], dim: int = -1) -> torch.Tensor:
    """Stack the named entries of a dataset into one tensor along ``dim``."""
    return torch.stack([torch.as_tensor(ds[n]) for n in names], dim=dim)


def unstack_dataset(arr: torch.Tensor, names: Iterable[str], dim: int = -1) -> Dataset:
    """Split a tensor into a dataset of named entries along ``dim``."""
    names = list(names)
    return dict(zip(names, torch.unbind(torch.as_tensor(arr), dim=dim)))


def to_model_dataset(samples: Dataset, variables) -> tuple[Dataset, Dataset]:
    """Denormalize a dataset of normalized variable values.

    :returns: ``(model_inputs, extras)``: the denormalized entries of the given
        variables, and the entries no variable names, untouched
    """
    by_name = {v.name: v for v in variables}
    out: Dataset = {}
    extras: Dataset = {}
    for key, value in samples.items():
        if key in by_name:
            out[key] = by_name[key].denormalize(value)
        else:
            extras[key] = value
    return out, extras


def dataset_shape(ds: Dataset) -> tuple:
    """Leading (loop) shape of the entries of a dataset."""
    shapes = [tuple(np.shape(v)) for v in ds.values()]
    return max(shapes, key=len)[:1] if shapes else ()


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def as_numpy(ds: Dataset) -> dict:
    """The dataset's entries as host numpy arrays."""
    return {k: to_numpy(v) for k, v in ds.items()}
