"""System configuration files in JSON (the counterpart of the JAX package's
``core/yaml_loader.py``; the port reads no YAML).

A file holds one System document: ``{"name": ..., "components": [...]}``, each
component a mapping of its fields (``name``, ``model`` as a dotted path,
``model_fidelity``, ``inputs`` and ``outputs`` as lists of variable mappings,
...) whose other keys become the model's keyword arguments. The JSON copies of
the YAML configurations live in ``hallthrusterpem_tpu_torch/configs/``: a
``!!python/name:`` tag there is the same dotted string. Saved state (recorded
model costs, computed compression maps) goes into the document's ``state`` entry;
the arrays of trained surrogates go into a sidecar ``<file>.state.pkl``, a
numpy-only pickle in the layout of the JAX package's ``.yml.state.pkl``, so that
either package loads what the other saved (:func:`load_state`).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any

import numpy as np

from hallthrusterpem_tpu_torch.core.component import Component, _as_tuple
from hallthrusterpem_tpu_torch.core.system import System
from hallthrusterpem_tpu_torch.core.variables import Compression, Variable

__all__ = ["load_system", "save_system", "load_state", "find_latest_save", "variable_to_dict", "config_dir"]

_COMPONENT_FIELDS = {"name", "model", "vectorized", "inputs", "outputs", "model_fidelity",
                     "data_fidelity", "training_data", "model_kwargs"}
_DIST_NAMES = {"uniform": "Uniform", "loguniform": "LogUniform", "normal": "N", "relative": "Relative",
               "tolerance": "Tolerance"}


def config_dir() -> Path:
    """Directory of the packaged System configurations."""
    return Path(__file__).parents[1] / "configs"


def _build_component(d: dict) -> Component:
    known = {k: v for k, v in d.items() if k in _COMPONENT_FIELDS}
    model_kwargs = dict(known.pop("model_kwargs", {}))
    model_kwargs.update({k: v for k, v in d.items() if k not in _COMPONENT_FIELDS})
    return Component(model_kwargs=model_kwargs, **known)


def _sidecar(path: Path) -> Path:
    return path.with_suffix(path.suffix + ".state.pkl")


def load_system(path, device=None) -> System:
    """The System a JSON file describes, on ``device`` (a CUDA device unless
    ``"cpu"`` is given), with the state of its sidecar ``<file>.state.pkl`` when
    there is one. A bare file name that is not in the working directory
    is looked up in :func:`config_dir`; such a packaged System gets no
    ``root_dir``, so saving it never writes into the package. A missing file
    raises ``FileNotFoundError``."""
    path = Path(path)
    packaged = path.parent == Path(".") and not path.exists()
    if packaged:
        path = config_dir() / path.name
    with open(path, "r", encoding="utf-8") as fd:
        doc = json.load(fd)
    if not isinstance(doc, dict) or not isinstance(doc.get("components"), list):
        raise ValueError(f"{path} does not contain a System document")
    system = System([_build_component(c) for c in doc["components"]], name=doc.get("name", "System"),
                    root_dir=None if packaged else path.parent, device=device)
    _load_json_state(system, doc.get("state", {}))
    if _sidecar(path).exists():
        load_state(system, _sidecar(path))
    return system


def variable_to_dict(v: Variable) -> dict:
    d: dict[str, Any] = {"name": v.name}
    for key in ("description", "category", "tex", "units"):
        if getattr(v, key):
            d[key] = getattr(v, key)
    if v.nominal is not None:
        d["nominal"] = float(v.nominal)
    if v.domain is not None:
        d["domain"] = f"({v.domain[0]}, {v.domain[1]})"
    if v.distribution is not None:
        args = ", ".join(repr(p) for p in v.distribution.params)
        d["distribution"] = f"{_DIST_NAMES[v.distribution.kind]}({args})"
    if v.norm:
        d["norm"] = "; ".join(n.kind if not n.params else f"{n.kind}({', '.join(repr(p) for p in n.params)})"
                              for n in v.norm)
    if v.compression is not None:
        c = v.compression
        cd: dict[str, Any] = {"method": c.method}
        if c.rank is not None:
            cd["rank"] = int(c.rank)
        if c.energy_tol is not None:
            cd["energy_tol"] = float(c.energy_tol)
        if c.reconstruction_tol is not None:
            cd["reconstruction_tol"] = float(c.reconstruction_tol)
        d["compression"] = cd
    return d


def save_system(system: System, path) -> Path:
    """Write the system's document, with its state, as JSON, and the sidecar
    ``<file>.state.pkl`` when the system has state (a stale one is removed)."""
    path = Path(path)
    doc: dict[str, Any] = {"name": system.name, "components": [c.to_dict() for c in system.components]}
    state = _collect_json_state(system)
    if state:
        doc["state"] = state
    with open(path, "w", encoding="utf-8") as fd:
        json.dump(doc, fd, indent=1)
    pickled = _collect_pickled_state(system)
    if pickled:
        with open(_sidecar(path), "wb") as fd:
            pickle.dump(pickled, fd)
    elif _sidecar(path).exists():
        _sidecar(path).unlink()
    return path


def find_latest_save(base) -> Path:
    """The newest trained, iteration or compression save under a configuration's
    directory tree; ``base`` when there is none."""
    base = Path(base)
    root = base if base.is_dir() else base.parent
    for pattern in ("*_trained.json", "*_iter*.json", "*_compression.json"):
        cands = sorted(root.rglob(pattern), key=lambda p: p.stat().st_mtime)
        if cands:
            return cands[-1]
    return base


def _collect_json_state(system: System) -> dict:
    state: dict[str, Any] = {}
    costs = {comp.name: [[list(alpha), n, total] for alpha, (n, total) in comp.model_costs.items()]
             for comp in system.components if comp.model_costs}
    if costs:
        state["model_costs"] = costs
    compression = {}
    for comp in system.components:
        for var in comp.outputs:
            c = var.compression
            if c is not None and c.projection is not None:
                compression[var.name] = {"projection": np.asarray(c.projection).tolist(), "rank": c.rank,
                                         "coords": None if c.coords is None else np.asarray(c.coords).tolist()}
    if compression:
        state["compression"] = compression
    return state


def _load_json_state(system: System, state: dict) -> None:
    for comp in system.components:
        for alpha, n, total in state.get("model_costs", {}).get(comp.name, []):
            comp.model_costs[_as_tuple(alpha)] = (n, total)
        for var in comp.outputs:
            cstate = state.get("compression", {}).get(var.name)
            if cstate is not None:
                if var.compression is None:
                    var.compression = Compression()
                var.compression.projection = np.asarray(cstate["projection"])
                var.compression.coords = None if cstate["coords"] is None else np.asarray(cstate["coords"])
                var.compression.rank = cstate["rank"]


def _collect_pickled_state(system: System) -> dict:
    """The system's state in the layout of the JAX package's
    ``yaml_loader._collect_state``: numpy arrays and Python values only."""
    state: dict[str, Any] = {"compression": {}, "surrogates": {}, "model_costs": {},
                             "train_history": system.train_history}
    has_any = bool(system.train_history)
    for comp in system.components:
        if comp.model_costs:
            state["model_costs"][comp.name] = {tuple(k): v for k, v in comp.model_costs.items()}
            has_any = True
        for var in comp.outputs:
            c = var.compression
            if c is not None and c.projection is not None:
                state["compression"][var.name] = {"projection": np.asarray(c.projection), "rank": c.rank,
                                                  "coords": None if c.coords is None else np.asarray(c.coords)}
                has_any = True
        if comp.surrogate is not None:
            state["surrogates"][comp.name] = comp.surrogate.to_state()
            has_any = True
    if system.system_surrogate is not None:
        state["system_surrogate"] = system.system_surrogate.to_state()
        has_any = True
    return state if has_any else {}


def load_state(system: System, path) -> None:
    """Load a state pickle into ``system``: the JAX package's ``.yml.state.pkl``
    or this package's sidecar (the same layout). Model costs, compression maps,
    component (MISC) surrogates, the training history and the system-level MLP
    surrogate, on the system's device. Read only files these packages wrote:
    unpickling runs code."""
    from hallthrusterpem_tpu_torch.surrogate.component import ComponentSurrogate
    from hallthrusterpem_tpu_torch.surrogate.mlp import MLPSurrogate

    with open(path, "rb") as fd:
        state = pickle.load(fd)
    for comp in system.components:
        comp.model_costs.update(state.get("model_costs", {}).get(comp.name, {}))
        for var in comp.outputs:
            cstate = state.get("compression", {}).get(var.name)
            if cstate is not None:
                if var.compression is None:
                    var.compression = Compression()
                var.compression.projection = cstate["projection"]
                var.compression.coords = cstate["coords"]
                var.compression.rank = cstate["rank"]
        sstate = state.get("surrogates", {}).get(comp.name)
        if sstate is not None:
            comp.surrogate = ComponentSurrogate.from_state(sstate, comp, device=system.device)
    system.train_history = state.get("train_history", [])
    sys_state = state.get("system_surrogate")
    if sys_state is not None:
        # compression maps were restored above, so the layout is reproducible
        system.system_surrogate = MLPSurrogate.from_state(sys_state, system)
