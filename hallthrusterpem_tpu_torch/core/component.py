"""Component: one node of the coupled-system DAG (the JAX package's
``core/component.py``). A component's model is a batched function
``f(Dataset, **kwargs) -> Dataset``; the configuration files name it by a dotted
path, which :func:`resolve_model` maps onto the port.
"""

from __future__ import annotations

import importlib
import inspect
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from hallthrusterpem_tpu_torch.core.dataset import Dataset
from hallthrusterpem_tpu_torch.core.variables import Variable
from hallthrusterpem_tpu_torch.tracing import span

__all__ = ["Component", "resolve_model"]

_PACKAGE = "hallthrusterpem_tpu_torch"
#: the reference's model paths, as the configuration files may name them
_MODEL_ALIASES = {
    "hallmd.models.cathode.cathode_coupling": f"{_PACKAGE}.models.cathode.cathode_coupling",
    "hallmd.models.thruster.hallthruster_jl": f"{_PACKAGE}.models.thruster.hallthruster_jl",
    "hallmd.models.plume.current_density": f"{_PACKAGE}.models.plume.current_density",
}


def resolve_model(model) -> Callable:
    """A model given as a callable or a dotted import path. Paths into the JAX
    package (``hallthrusterpem_tpu.``) and the reference's (``hallmd.models.``)
    resolve to the port's module of the same name."""
    if callable(model):
        return model
    path = _MODEL_ALIASES.get(str(model), str(model))
    if path.startswith("hallthrusterpem_tpu."):
        path = _PACKAGE + path[len("hallthrusterpem_tpu"):]
    module_name, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


def _as_tuple(value) -> tuple:
    if value is None:
        return ()
    if isinstance(value, str):
        toks = value.strip().lstrip("([").rstrip(")]").split(",")
        return tuple(int(t) for t in toks if t.strip())
    if isinstance(value, (int, np.integer)):
        return (int(value),)
    return tuple(int(v) for v in value)


def _synchronize(out) -> None:
    """Wait for the CUDA devices the outputs lie on, so the clock reads the work."""
    devices = {v.device for v in out.values() if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


@dataclass
class Component:
    name: str
    model: Any = None
    vectorized: bool = True
    inputs: list[Variable] = field(default_factory=list)
    outputs: list[Variable] = field(default_factory=list)
    model_fidelity: tuple = ()
    data_fidelity: tuple = ()
    training_data: dict = field(default_factory=lambda: {"method": "sparse-grid", "knots_per_level": 2})
    model_kwargs: dict = field(default_factory=dict)
    #: (evaluations, seconds) of the model keyed by model-fidelity tuple
    model_costs: dict = field(default_factory=dict)
    #: the MISC surrogate the trainer installs (None: no surrogate)
    surrogate: Any = None

    def __post_init__(self):
        self.model_fidelity = _as_tuple(self.model_fidelity)
        self.data_fidelity = _as_tuple(self.data_fidelity)
        self.inputs = [v if isinstance(v, Variable) else Variable.from_dict(v) for v in self.inputs]
        self.outputs = [v if isinstance(v, Variable) else Variable.from_dict(v) for v in self.outputs]

    @property
    def fn(self) -> Callable:
        return resolve_model(self.model)

    def input_names(self) -> list[str]:
        return [v.name for v in self.inputs]

    def output_names(self) -> list[str]:
        return [v.name for v in self.outputs]

    def __getitem__(self, var_name: str) -> Variable:
        for v in list(self.inputs) + list(self.outputs):
            if v.name == var_name:
                return v
        raise KeyError(var_name)

    def call_model(self, inputs: Dataset, model_fidelity: Optional[tuple] = None, **extra) -> Dataset:
        """Evaluate the model on a batch of inputs (model units).

        The component's extra keyword arguments (``model_kwargs``) and ``extra``
        are passed where the model's signature takes them, with ``model_fidelity``
        when it has one. The wall time, the card synchronised, is added to
        ``model_costs``."""
        fn = self.fn
        kwargs = dict(self.model_kwargs)
        kwargs.update(extra)
        alpha = self.model_fidelity if model_fidelity is None else _as_tuple(model_fidelity)
        try:
            sig_params = set(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            sig_params = None
        if sig_params is not None:
            if "model_fidelity" in sig_params and alpha:
                kwargs["model_fidelity"] = alpha
            kwargs = {k: v for k, v in kwargs.items() if k in sig_params}
        batch = {k: v for k, v in inputs.items() if k in self.input_names()}

        with span(f"call_model.{self.name}"):
            t0 = time.perf_counter()
            out = fn(batch, **kwargs)
            with span("wait.call_model"):
                _synchronize(out)
            elapsed = time.perf_counter() - t0

        n = max([1] + [int(np.shape(v)[0]) for v in batch.values() if np.ndim(v) > 0])
        prev_evals, prev_cost = self.model_costs.get(alpha, (0, 0.0))
        self.model_costs[alpha] = (prev_evals + n, prev_cost + elapsed)
        return out

    def get_cost(self, alpha: tuple = (), beta: tuple = ()) -> float:
        """Seconds per model evaluation at fidelity ``alpha``, from the recorded costs."""
        alpha = _as_tuple(alpha)
        if alpha in self.model_costs:
            n, total = self.model_costs[alpha]
            return total / max(n, 1)
        if self.model_costs:
            return float(np.mean([t / max(n, 1) for (n, t) in self.model_costs.values()]))
        return 1.0

    def _model(self, inputs: Dataset, alpha: Optional[tuple] = None, **kwargs) -> Dataset:
        """Legacy entry point: :meth:`call_model` at fidelity ``alpha``."""
        return self.call_model(inputs, model_fidelity=alpha, **kwargs)

    @property
    def max_refine(self) -> tuple:
        """The highest fidelity index: the component's model fidelity."""
        return tuple(self.model_fidelity)

    @property
    def truth_alpha(self) -> tuple:
        """The fidelity of the true model: the component's model fidelity."""
        return tuple(self.model_fidelity)

    def to_dict(self) -> dict:
        from hallthrusterpem_tpu_torch.core.json_loader import variable_to_dict

        model = self.model if isinstance(self.model, str) or self.model is None else (
            f"{self.fn.__module__}.{self.fn.__qualname__}")
        return {
            "name": self.name,
            "model": model,
            "vectorized": self.vectorized,
            "model_fidelity": list(self.model_fidelity),
            "data_fidelity": list(self.data_fidelity),
            "training_data": dict(self.training_data),
            "model_kwargs": dict(self.model_kwargs),
            "inputs": [variable_to_dict(v) for v in self.inputs],
            "outputs": [variable_to_dict(v) for v in self.outputs],
        }
