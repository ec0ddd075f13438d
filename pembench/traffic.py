"""The one generator of the benchmark's traffic: the rows of every call of a
cell, drawn with numpy from ``--seed`` and the call's index, so that the same
seed gives the same calls.

A traffic mix is a JSON file under ``pembench/traffic/`` that sets:

- ``rows_per_call``: rows of each ``System.predict`` call;
- ``conditions`` (optional): ``{"file", "inputs"}``, operating conditions held
  in a data file under ``pembench/`` (an ``.npz``, one array per input); every
  call repeats all of them;
- ``calibration`` (optional): ``{"file", "key", "names", "mode"}``, posterior
  draws (``key``: a (draws, len(names)) array) of the inputs ``names``; with
  ``"mode": "all"`` a call takes every draw at every condition (draw-major);
  with ``"mode": "walk"`` call k takes draw ``perm[k % draws]`` (``perm`` from
  the seed), moved by a Gaussian step of ``step`` times each input's domain
  width over the square root of the number of inputs, reflected into the
  domain, at every condition;
- ``redraw``: inputs drawn anew for each row from their distribution, centred
  on the condition's value (or the nominal) for a relative one;
- ``rest``: ``"prior"`` draws every other input as ``System.sample_inputs``
  does: from its distribution if its category or name is in ``use_pdf``
  (every input when the mix has no ``use_pdf``; uniform on its domain without
  a distribution), else uniform on its domain; ``"nominal"`` holds it at its
  nominal.

Inputs are the system's exogenous inputs, read from the configuration file.
Every row is float32, as the system's own sampler gives them.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def exogenous_inputs(doc: dict) -> dict:
    """Name -> full definition of every input no component produces, in the
    order the components list them."""
    produced = {o["name"] for c in doc["components"] for o in c.get("outputs", [])}
    found = {}
    for comp in doc["components"]:
        for var in comp.get("inputs", []):
            if var["name"] not in produced and len(var) > 1:
                found.setdefault(var["name"], var)
    return found


def _numbers(text: str) -> list:
    return [float(t) for t in str(text).strip().strip("()[]").split(",") if t.strip()]


def _parse(spec: str):
    """A distribution ``Name(a, b, ...)`` as (kind, [a, b, ...])."""
    m = re.match(r"\s*([A-Za-z]+)\s*(\(.*\))\s*$", str(spec))
    if m is None:
        raise ValueError(f"cannot parse {spec!r}")
    kind = {"u": "uniform", "uniform": "uniform", "loguniform": "loguniform", "n": "normal",
            "normal": "normal", "relative": "relative", "tolerance": "tolerance"}[m.group(1).lower()]
    return kind, _numbers(m.group(2))


def domain(var: dict) -> tuple:
    """The input's domain; its distribution's support when it names none (a
    normal one: three standard deviations about the mean)."""
    if var.get("domain") is not None:
        lo, hi = _numbers(var["domain"])
        return lo, hi
    kind, p = _parse(var["distribution"])
    if kind == "normal":
        return p[0] - 3 * p[1], p[0] + 3 * p[1]
    if kind == "relative":
        nom = float(var["nominal"])
        return tuple(sorted((nom * (1 - p[0] / 100), nom * (1 + p[0] / 100))))
    if kind == "tolerance":
        nom = float(var["nominal"])
        return nom - p[0], nom + p[0]
    return p[0], p[1]


def draw(var: dict, rng: np.random.Generator, n: int, centre=None) -> np.ndarray:
    """``n`` draws from the input's distribution (uniform on its domain without
    one); a relative or tolerance one is centred on ``centre`` or the nominal."""
    if var.get("distribution") is None:
        lo, hi = domain(var)
        return lo + (hi - lo) * rng.random(n)
    kind, p = _parse(var["distribution"])
    nom = np.asarray(float(var["nominal"]) if centre is None else centre, dtype=np.float64)
    if kind == "uniform":
        return p[0] + (p[1] - p[0]) * rng.random(n)
    if kind == "loguniform":
        lo, hi = np.log10(p[0]), np.log10(p[1])
        return 10.0 ** (lo + (hi - lo) * rng.random(n))
    if kind == "normal":
        return p[0] + p[1] * rng.standard_normal(n)
    lo, hi = (nom * (1 - p[0] / 100), nom * (1 + p[0] / 100)) if kind == "relative" else (nom - p[0], nom + p[0])
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    return lo + (hi - lo) * rng.random(n)


def _reflect(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    width = hi - lo
    y = np.mod(x - lo, 2 * width)
    return lo + np.where(y > width, 2 * width - y, y)


class Traffic:
    """The calls of one cell for one seed: ``call(k)`` is the k-th call's rows."""

    def __init__(self, doc: dict, mix: dict, seed: int):
        self.doc, self.mix, self.seed = doc, mix, int(seed)
        self.inputs = exogenous_inputs(doc)
        self.rows = int(mix["rows_per_call"])
        self.conditions = {}
        if mix.get("conditions"):
            with np.load(ROOT / mix["conditions"]["file"]) as f:
                self.conditions = {k: np.asarray(f[k], np.float64) for k in mix["conditions"]["inputs"]}
        self.n_cond = len(next(iter(self.conditions.values()))) if self.conditions else 1
        cal = mix.get("calibration")
        self.draws, self.names = None, []
        if cal:
            with np.load(ROOT / cal["file"]) as f:
                self.draws = np.asarray(f[cal["key"]], np.float64)
                self.names = [str(n) for n in (f[cal["names"]] if isinstance(cal["names"], str) else cal["names"])]
            per_call = self.draws.shape[0] * self.n_cond if cal["mode"] == "all" else self.n_cond
            self.perm = np.random.default_rng([self.seed, 0]).permutation(self.draws.shape[0])
        else:
            per_call = self.rows
        if per_call != self.rows:
            raise ValueError(f"the mix gives {per_call} rows a call, not rows_per_call={self.rows}")
        unknown = set(self.conditions) | set(self.names) | set(mix.get("redraw", []))
        if unknown - set(self.inputs):
            raise ValueError(f"not inputs of the system: {sorted(unknown - set(self.inputs))}")

    def call(self, k: int) -> dict:
        """Name -> float32 array (rows,) of call ``k`` (k < 0: the warm-up's)."""
        rng = np.random.default_rng([self.seed, 1, k + 1_000_000])
        n, cal = self.rows, self.mix.get("calibration")
        reps = n // self.n_cond
        rows = {}
        if cal and cal["mode"] == "all":
            for j, name in enumerate(self.names):
                rows[name] = np.repeat(self.draws[:, j], self.n_cond)
        elif cal:
            theta = self.draws[self.perm[k % len(self.perm)]].copy()
            doms = np.array([domain(self.inputs[name]) for name in self.names])
            sd = float(cal["step"]) * (doms[:, 1] - doms[:, 0]) / np.sqrt(len(self.names))
            theta = _reflect(theta + sd * rng.standard_normal(len(theta)), doms[:, 0], doms[:, 1])
            for j, name in enumerate(self.names):
                rows[name] = np.full(n, theta[j])
        for name, values in self.conditions.items():
            rows[name] = np.tile(values, reps)
        rest, use_pdf = self.mix.get("rest", "nominal"), self.mix.get("use_pdf")
        for name, var in self.inputs.items():
            if name in self.mix.get("redraw", []):
                rows[name] = draw(var, rng, n, centre=rows.get(name))
            elif name in rows:
                continue
            elif rest != "prior":
                rows[name] = np.full(n, float(var["nominal"]))
            elif use_pdf is None or var.get("category") in use_pdf or name in use_pdf:
                rows[name] = draw(var, rng, n)
            else:
                lo, hi = domain(var)
                rows[name] = lo + (hi - lo) * rng.random(n)
        return {name: rows[name].astype(np.float32) for name in self.inputs}


def load_mix(name: str) -> dict:
    with open(ROOT / "traffic" / f"{name}.json", encoding="utf-8") as fd:
        return json.load(fd)
