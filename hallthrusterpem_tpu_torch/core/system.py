"""System: a DAG of components evaluated feed-forward over a batch axis (the
JAX package's ``core/system.py``).

``predict(use_model="best")`` is one sweep over the components in dependency
order, each model batched over ``(batch, ...)`` tensors on the system's device (a
CUDA device unless the caller passes ``device="cpu"``). ``predict(use_model=None)``
runs the trained surrogates instead: the system-level MLP ensemble
(``system_surrogate``) when one is set, else each component's MISC surrogate
where it has one. ``fit`` trains the MISC surrogates, ``as_torch_fn`` returns the
surrogate chain as a pure function on tensors. ``plot_slice`` and
``plot_allocation`` draw through :mod:`hallthrusterpem_tpu_torch.viz`.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from hallthrusterpem_tpu_torch.core.component import Component
from hallthrusterpem_tpu_torch.core.dataset import Dataset
from hallthrusterpem_tpu_torch.core.variables import Variable
from hallthrusterpem_tpu_torch.utils import resolve_device

__all__ = ["System"]


class _Graph:
    """The DAG as ``graph.nodes[name]['exo_in']`` (indices of the component's
    exogenous inputs among the system's) and ``graph.edges``."""

    def __init__(self):
        self.nodes: dict[str, dict] = {}
        self.edges: list[tuple[str, str]] = []


class System:
    def __init__(self, components: Sequence[Component], name: str = "System",
                 root_dir: Optional[str] = None, device=None):
        self.components: list[Component] = list(components)
        self.name = name
        self.root_dir = Path(root_dir) if root_dir else None
        self.device = resolve_device(device)
        self.train_history: list[dict] = []
        self.system_surrogate = None  # optional end-to-end surrogate (surrogate.mlp)
        self.logger = logging.getLogger(f"hallthrusterpem_tpu_torch.{name}")
        self._link_variables()
        self._topo_sort()
        self._build_graph()

    # ------------------------------------------------------------------ structure
    def _link_variables(self):
        """Unify variables by name across components: a bare ``{name: X}`` entry
        takes the first full definition of X."""
        registry: dict[str, Variable] = {}
        for comp in self.components:
            for vlist in (comp.inputs, comp.outputs):
                for i, var in enumerate(vlist):
                    existing = registry.get(var.name)
                    is_bare = not (
                        var.description or var.category or var.tex or var.units
                        or var.nominal is not None or var.domain is not None
                        or var.distribution is not None or var.norm or var.compression
                    )
                    if existing is not None and is_bare:
                        vlist[i] = existing
                    else:
                        registry[var.name] = vlist[i]
        self._variables = registry

    def _topo_sort(self):
        produced = {out: comp.name for comp in self.components for out in comp.output_names()}
        order: list[Component] = []
        remaining = list(self.components)
        while remaining:
            progressed = False
            for comp in list(remaining):
                deps = {produced[n] for n in comp.input_names() if n in produced and produced[n] != comp.name}
                if deps.issubset({c.name for c in order}):
                    order.append(comp)
                    remaining.remove(comp)
                    progressed = True
            if not progressed:
                raise ValueError(f"Cyclic or unresolvable component dependencies among {[c.name for c in remaining]}")
        self.components = order

    def _build_graph(self):
        g = _Graph()
        produced = {out: comp.name for comp in self.components for out in comp.output_names()}
        exo_names = [v.name for v in self.inputs()]
        for comp in self.components:
            exo_in = [exo_names.index(n) for n in comp.input_names() if n in exo_names]
            g.nodes[comp.name] = {"exo_in": exo_in, "component": comp}
            for n in comp.input_names():
                if n in produced and produced[n] != comp.name:
                    g.edges.append((produced[n], comp.name))
        self.graph = g

    # ------------------------------------------------------------------ accessors
    def __getitem__(self, comp_name: str) -> Component:
        for comp in self.components:
            if comp.name == comp_name:
                return comp
        raise KeyError(comp_name)

    def inputs(self) -> list[Variable]:
        """Exogenous inputs: component inputs no component produces."""
        produced = {n for comp in self.components for n in comp.output_names()}
        seen, out = set(), []
        for comp in self.components:
            for var in comp.inputs:
                if var.name not in produced and var.name not in seen:
                    seen.add(var.name)
                    out.append(var)
        return out

    def outputs(self) -> list[Variable]:
        seen, out = set(), []
        for comp in self.components:
            for var in comp.outputs:
                if var.name not in seen:
                    seen.add(var.name)
                    out.append(var)
        return out

    @property
    def coupling_vars(self) -> list[Variable]:
        """Variables one component produces and another consumes."""
        consumed = {n for comp in self.components for n in comp.input_names()}
        return [v for v in self.outputs() if v.name in consumed]

    # ------------------------------------------------------------------ sampling
    def sample_inputs(
        self,
        shape,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        normalize: bool = False,
        use_pdf: Iterable[str] | bool = (),
        nominal: Optional[dict] = None,
        constants: Iterable[str] = (),
        domain_filter=None,
        max_rejection_rounds: int = 50,
    ) -> Dataset:
        """Draw the exogenous inputs, as float32 tensors on the system's device.

        :param shape: leading sample shape (int or tuple)
        :param generator: the CPU ``torch.Generator`` every draw comes from, in
            the order of :meth:`inputs` (one seeded with ``seed`` when omitted)
        :param use_pdf: categories (or names) whose variables draw from their
            distribution; the others draw uniformly over their domain; True = all
        :param nominal: per-variable nominal overrides (the centres of Relative()
            and the values of ``constants``)
        :param constants: categories (or variable names) held at their nominal
        :param normalize: return the values in normalized space
        :param domain_filter: optional ``samples dict -> bool keep-mask`` on numpy
            arrays; rejected rows are drawn again until the whole batch passes
        :param max_rejection_rounds: cap on those redraws
        """
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        nominal = nominal or {}
        use_pdf = self._category_set(use_pdf)
        constants = self._category_set(constants)

        def draw(shape) -> Dataset:
            samples: Dataset = {}
            for var in self.inputs():
                nom = nominal.get(var.name, var.nominal)
                if var.category in constants or var.name in constants:
                    if nom is None:
                        raise ValueError(f"Variable {var.name} frozen as constant but has no nominal")
                    samples[var.name] = torch.full(shape, float(nom), dtype=torch.float32)
                elif var.category in use_pdf or var.name in use_pdf:
                    samples[var.name] = var.sample(generator, shape, nominal=nom)
                else:
                    samples[var.name] = var.sample_domain(generator, shape)
            return samples

        samples = draw(shape)
        if domain_filter is not None:
            flat = {k: v.reshape(-1).numpy() for k, v in samples.items()}
            keep = np.asarray(domain_filter(flat), dtype=bool)
            rounds = 0
            while not keep.all():
                rounds += 1
                if rounds > max_rejection_rounds:
                    raise RuntimeError(
                        f"domain_filter accepted only {float(keep.mean()):.1%} after "
                        f"{max_rejection_rounds} rounds; the trimmed domain is too small")
                bad = np.flatnonzero(~keep)
                for name, v in draw((bad.size,)).items():
                    flat[name][bad] = v.numpy()
                keep[bad] = np.asarray(domain_filter({k: v[bad] for k, v in flat.items()}), dtype=bool)
            samples = {k: torch.as_tensor(v).reshape(shape) for k, v in flat.items()}

        variables = {v.name: v for v in self.inputs()}
        if normalize:
            samples = {k: variables[k].normalize(v) for k, v in samples.items()}
        return {k: v.to(self.device) for k, v in samples.items()}

    def _category_set(self, spec) -> set:
        if spec is True:
            return {v.category for v in self.inputs()} | {v.name for v in self.inputs()}
        if isinstance(spec, str):
            return {spec}
        return set(spec or ())

    # ------------------------------------------------------------------ prediction
    def predict(
        self,
        samples: Dataset,
        use_model: Optional[str] = None,
        normalized: bool = False,
        model_dir=None,
        verbose: bool = False,
        training: bool = False,
        qoi_ind: Optional[Sequence[str]] = None,
        **kwargs,
    ) -> Dataset:
        """Feed-forward coupled prediction over a batch of input samples.

        :param samples: dataset keyed by exogenous-input name, one leading shape;
            values are moved to the system's device
        :param use_model: ``'best'``/``'truth'`` runs the true models at their
            fidelity, ``'worst'`` at the lowest fidelity; None runs the trained
            surrogates: the system-level one when set, else each component's
            MISC surrogate where it has one (the true model where not)
        :param normalized: whether ``samples`` are in normalized space
        :param model_dir: each component that takes an ``output_path`` writes its
            raw output under ``model_dir/<component name>``
        :param training: MISC surrogates evaluate their active index set only
        :param qoi_ind: return only these outputs (and their coordinates)
        """
        data: Dataset = {}
        for name, value in samples.items():
            value = torch.as_tensor(value, device=self.device)
            var = self._variables.get(name)
            data[name] = var.denormalize(value) if (normalized and var is not None) else value

        if use_model is None and self.system_surrogate is not None:
            data.update(self.system_surrogate.predict(data, training=training, qoi_ind=qoi_ind))
            return self._select(data, qoi_ind)

        for comp in self.components:
            missing = [n for n in comp.input_names() if n not in data]
            if missing:
                raise KeyError(f"Component {comp.name} missing inputs {missing}")
            batch = {n: data[n] for n in comp.input_names()}
            if verbose:
                self.logger.info("Evaluating component %s ...", comp.name)
            if use_model is None and comp.surrogate is not None:
                out = comp.surrogate.predict(batch, training=training)
                data.update({k: torch.as_tensor(v, device=self.device) for k, v in out.items()})
                continue
            extra = {"device": self.device}
            if model_dir is not None:
                comp_dir = Path(model_dir) / comp.name
                comp_dir.mkdir(parents=True, exist_ok=True)
                extra["output_path"] = str(comp_dir)
            if use_model == "worst":
                extra["model_fidelity"] = tuple(0 for _ in comp.model_fidelity)
            data.update(comp.call_model(batch, **extra))
        return self._select(data, qoi_ind)

    @staticmethod
    def _select(data: Dataset, qoi_ind) -> Dataset:
        if qoi_ind is not None:
            keep = set(qoi_ind) | {f"{q}_coords" for q in qoi_ind}
            return {k: v for k, v in data.items() if k in keep}
        return data

    def __call__(self, samples: Dataset, **kwargs) -> Dataset:
        return self.predict(samples, **kwargs)

    def as_torch_fn(self, training: bool = True, qoi_ind: Optional[Sequence[str]] = None):
        """Feed-forward system prediction through the trained surrogates as a pure
        ``samples -> outputs`` function on tensors on the system's device (the
        device-side counterpart of ``predict(use_model=None)``, e.g. for a batched
        posterior or a Sobol' sweep). Every component must have a surrogate
        unless a system-level one is set. Compressed field outputs come back as
        latent coefficients, as from :meth:`predict`."""
        if self.system_surrogate is not None:
            return self.system_surrogate.as_torch_fn(training=training, qoi_ind=qoi_ind)
        chain = []
        for comp in self.components:
            if comp.surrogate is None:
                raise ValueError(f"Component {comp.name} has no trained surrogate; "
                                 "as_torch_fn requires a fully-trained system")
            chain.append((comp.input_names(), comp.surrogate.as_torch_fn(training=training)))

        keep = None if qoi_ind is None else set(qoi_ind)

        def fn(samples: Dataset) -> Dataset:
            data = dict(samples)
            for in_names, f in chain:
                data.update(f({n: data[n] for n in in_names}))
            return data if keep is None else {k: v for k, v in data.items() if k in keep}

        return fn

    as_jax_fn = as_torch_fn  # the JAX package's name, for code written against it

    # ------------------------------------------------------------------ training
    def fit(self, **kwargs):
        """Adaptive multi-fidelity (MISC) surrogate training:
        :func:`hallthrusterpem_tpu_torch.surrogate.train.fit_system`."""
        from hallthrusterpem_tpu_torch.surrogate.train import fit_system

        return fit_system(self, **kwargs)

    def clear(self):
        """Drop all trained surrogate state."""
        for comp in self.components:
            comp.surrogate = None
        self.system_surrogate = None
        self.train_history = []

    def load_training_cache(self, path) -> int:
        """Merge a mid-fit training-data cache (written by
        ``fit(cache_interval=...)``, by either package) into the component
        surrogates' evaluation caches, so a restarted fit reuses the model
        evaluations. Returns the number of cached points."""
        import pickle

        from hallthrusterpem_tpu_torch.surrogate.component import ComponentSurrogate

        with open(path, "rb") as f:
            payload = pickle.load(f)
        n = 0
        for comp in self.components:
            entry = payload.get(comp.name)
            if entry is None:
                continue
            if comp.surrogate is None:
                comp.surrogate = ComponentSurrogate(comp, device=self.device)
            for alpha, cache in entry.get("eval_cache", {}).items():
                comp.surrogate.eval_cache.setdefault(alpha, {}).update(cache)
                n += len(cache)
            for alpha, keys in entry.get("repaired", {}).items():
                comp.surrogate._repaired_keys.setdefault(alpha, set()).update(map(tuple, keys))
            for alpha, rec in entry.get("model_costs", {}).items():
                comp.model_costs.setdefault(alpha, rec)
        return n

    def get_allocation(self):
        """Cost accounting: ``(cost_alloc, model_cost, overhead_cost, model_evals)``,
        the seconds and evaluations per component and model fidelity, their total
        seconds, and the trainer's own seconds."""
        cost_alloc: dict[str, dict] = {}
        model_cost = 0.0
        model_evals: dict[str, dict] = {}
        for comp in self.components:
            cost_alloc[comp.name] = {}
            model_evals[comp.name] = {}
            for alpha, (n, total) in comp.model_costs.items():
                cost_alloc[comp.name][alpha] = total
                model_evals[comp.name][alpha] = n
                model_cost += total
        overhead = sum(h.get("overhead_s", 0.0) for h in self.train_history)
        return cost_alloc, model_cost, overhead, model_evals

    # ------------------------------------------------------------------ plotting (thin)
    def plot_slice(self, *args, **kwargs):
        from hallthrusterpem_tpu_torch.viz import plot_slice

        return plot_slice(self, *args, **kwargs)

    def plot_allocation(self, *args, **kwargs):
        from hallthrusterpem_tpu_torch.viz import plot_allocation

        return plot_allocation(self, *args, **kwargs)

    # ------------------------------------------------------------------ io
    def set_logger(self, stdout: bool = False, level=logging.INFO):
        """Set the system logger's level; with ``stdout``, add a stream handler
        (once)."""
        self.logger.setLevel(level)
        if stdout and not any(isinstance(h, logging.StreamHandler) for h in self.logger.handlers):
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
            self.logger.addHandler(handler)

    def save_to_file(self, filename: str, save_dir=None) -> Path:
        from hallthrusterpem_tpu_torch.core.json_loader import save_system

        save_dir = Path(save_dir) if save_dir else (self.root_dir or Path("."))
        save_dir.mkdir(parents=True, exist_ok=True)
        return save_system(self, save_dir / filename)

    @staticmethod
    def load_from_file(path, root_dir=None, device=None) -> "System":
        from hallthrusterpem_tpu_torch.core.json_loader import load_system

        system = load_system(path, device=device)
        if root_dir is not None:
            system.root_dir = Path(root_dir)
        return system
