"""Typed random variables with the distribution and norm mini-languages of the
PEM configuration files (the JAX package's ``core/variables.py``).

Distributions: ``U(a, b)`` / ``Uniform(a, b)``, ``LogUniform(a, b)``,
``N(mu, sd)`` / ``Normal(mu, sd)``, ``Relative(pct)`` (uniform within pct% of the
nominal), ``Tolerance(tol)`` (uniform within tol of the nominal).
Norms: ``log10``, ``log``, ``linear(scale[, offset])``, ``zscore(mu, sd)``,
``minmax(lo, hi)``, ``none``, chained with ``;``.

Sampling draws from an explicit ``torch.Generator`` on the CPU, in float64, and
returns float32 tensors (the JAX package's draws are float32).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Distribution", "Norm", "Compression", "Variable", "parse_distribution", "parse_norms"]

_CALL_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(?:\((.*)\))?\s*$")


def _parse_call(spec: str) -> tuple[str, list[float]]:
    """``Name(a, b, ...)`` -> ``(name, [a, b, ...])``."""
    m = _CALL_RE.match(spec)
    if m is None:
        raise ValueError(f"Cannot parse spec string: {spec!r}")
    args = [float(tok) for tok in (m.group(2) or "").split(",") if tok.strip()]
    return m.group(1), args


def _parse_domain(domain) -> Optional[tuple[float, float]]:
    """A domain spec ``"(a, b)"`` or a 2-sequence as two floats."""
    if domain is None:
        return None
    if isinstance(domain, str):
        toks = domain.strip().lstrip("([").rstrip(")]").split(",")
        return (float(toks[0]), float(toks[1]))
    lo, hi = domain
    return (float(lo), float(hi))


def _uniform(generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=torch.float64)


def _xp(x):
    """torch for tensors, numpy for everything else."""
    return torch if isinstance(x, torch.Tensor) else np


def _density_on(x, lo, hi, value):
    """``value`` on ``[lo, hi]`` and 0 elsewhere, in the dtype of a floating
    tensor ``x`` (``torch.where`` of two Python floats would give float32). No
    host-to-device copy: a CUDA graph can capture it."""
    inside = (x >= lo) & (x <= hi)
    if isinstance(x, torch.Tensor):
        dtype = x.dtype if x.is_floating_point() else torch.get_default_dtype()
        return torch.where(inside, torch.full_like(x, value, dtype=dtype), 0.0)
    return np.where(inside, value, 0.0)


# ----------------------------------------------------------------------------------
# distributions
# ----------------------------------------------------------------------------------
@dataclass(frozen=True)
class Distribution:
    """A 1-D sampling distribution: ``kind`` in {uniform, loguniform, normal,
    relative, tolerance}; relative and tolerance are centred on a nominal given
    at sample time (a number, or one per sample)."""

    kind: str
    params: tuple[float, ...]

    def sample(self, generator: torch.Generator, shape, nominal=None) -> torch.Tensor:
        """``shape`` draws as a float32 CPU tensor."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if self.kind == "uniform":
            lo, hi = self.params
            out = lo + (hi - lo) * _uniform(generator, shape)
        elif self.kind == "loguniform":
            lo, hi = np.log10(self.params[0]), np.log10(self.params[1])
            out = 10.0 ** (lo + (hi - lo) * _uniform(generator, shape))
        elif self.kind == "normal":
            mu, sd = self.params
            out = mu + sd * torch.randn(shape, generator=generator, dtype=torch.float64)
        elif self.kind in ("relative", "tolerance"):
            if nominal is None:
                raise ValueError(f"{self.kind} distribution requires a nominal value")
            nom = torch.as_tensor(nominal, dtype=torch.float64).cpu()
            if self.kind == "relative":
                (pct,) = self.params
                a, b = nom * (1 - pct / 100.0), nom * (1 + pct / 100.0)
                lo, hi = torch.minimum(a, b), torch.maximum(a, b)
            else:
                (tol,) = self.params
                lo, hi = nom - tol, nom + tol
            out = lo + (hi - lo) * _uniform(generator, shape)
        else:
            raise ValueError(f"Unknown distribution kind {self.kind!r}")
        return out.to(torch.float32)

    def pdf(self, x, nominal: Optional[float] = None):
        xp = _xp(x)
        x = x if xp is torch else np.asarray(x)
        if self.kind == "uniform":
            lo, hi = self.params
            return _density_on(x, lo, hi, 1.0 / (hi - lo))
        if self.kind == "loguniform":
            lo, hi = self.params
            c = 1.0 / (np.log(hi) - np.log(lo))
            floored = torch.clamp(x, min=1e-300) if xp is torch else np.maximum(x, 1e-300)
            return xp.where((x >= lo) & (x <= hi), c / floored, 0.0)
        if self.kind == "normal":
            mu, sd = self.params
            return xp.exp(-0.5 * ((x - mu) / sd) ** 2) / (sd * np.sqrt(2 * np.pi))
        if self.kind in ("relative", "tolerance"):
            lo, hi = self.bounds(nominal) if nominal is not None else (None, None)
            if lo is None:
                raise ValueError(f"{self.kind} pdf requires a nominal value")
            return _density_on(x, lo, hi, 1.0 / (hi - lo))
        raise ValueError(f"Unknown distribution kind {self.kind!r}")

    def bounds(self, nominal: Optional[float] = None) -> Optional[tuple[float, float]]:
        if self.kind in ("uniform", "loguniform"):
            return (self.params[0], self.params[1])
        if self.kind == "normal":
            mu, sd = self.params
            return (mu - 3 * sd, mu + 3 * sd)
        if self.kind == "relative" and nominal is not None:
            (pct,) = self.params
            lo, hi = nominal * (1 - pct / 100.0), nominal * (1 + pct / 100.0)
            return (min(lo, hi), max(lo, hi))
        if self.kind == "tolerance" and nominal is not None:
            (tol,) = self.params
            return (nominal - tol, nominal + tol)
        return None

    @property
    def mu(self) -> float:
        """The mean of a normal or uniform distribution."""
        if self.kind == "normal":
            return self.params[0]
        if self.kind == "uniform":
            return 0.5 * (self.params[0] + self.params[1])
        raise AttributeError(f"mu undefined for {self.kind}")


_DIST_NAMES = {"u": "uniform", "uniform": "uniform", "loguniform": "loguniform", "n": "normal",
               "normal": "normal", "relative": "relative", "rel": "relative",
               "tolerance": "tolerance", "tol": "tolerance"}


def parse_distribution(spec) -> Optional[Distribution]:
    if spec is None or isinstance(spec, Distribution):
        return spec
    name, args = _parse_call(str(spec))
    kind = _DIST_NAMES.get(name.lower())
    if kind is None:
        raise ValueError(f"Unknown distribution {name!r}")
    return Distribution(kind, tuple(args))


# ----------------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------------
@dataclass(frozen=True)
class Norm:
    """One normalization transform: ``kind`` in {log10, log, linear, zscore, minmax, none}."""

    kind: str
    params: tuple[float, ...] = ()

    def _linear(self):
        scale = self.params[0] if self.params else 1.0
        offset = self.params[1] if len(self.params) > 1 else 0.0
        return scale, offset

    def forward(self, x):
        xp = _xp(x)
        if self.kind == "log10":
            return xp.log10(x)
        if self.kind == "log":
            return xp.log(x)
        if self.kind == "linear":
            scale, offset = self._linear()
            return x * scale + offset
        if self.kind == "zscore":
            mu, sd = self.params
            return (x - mu) / sd
        if self.kind == "minmax":
            lo, hi = self.params[:2]
            return (x - lo) / (hi - lo)
        if self.kind == "none":
            return x
        raise ValueError(f"Unknown norm {self.kind!r}")

    def inverse(self, y):
        xp = _xp(y)
        if self.kind == "log10":
            return 10.0 ** (y if xp is torch else np.asarray(y))
        if self.kind == "log":
            return xp.exp(y)
        if self.kind == "linear":
            scale, offset = self._linear()
            return (y - offset) / scale
        if self.kind == "zscore":
            mu, sd = self.params
            return y * sd + mu
        if self.kind == "minmax":
            lo, hi = self.params[:2]
            return y * (hi - lo) + lo
        if self.kind == "none":
            return y
        raise ValueError(f"Unknown norm {self.kind!r}")


def parse_norms(spec) -> tuple[Norm, ...]:
    """A norm spec such as ``"log10"``, ``"linear(1e6)"`` or a list of them."""
    if spec is None:
        return ()
    if isinstance(spec, Norm):
        return (spec,)
    if isinstance(spec, (list, tuple)):
        return tuple(n for s in spec for n in parse_norms(s))
    out = []
    for part in str(spec).split(";"):
        if part.strip():
            name, args = _parse_call(part.strip())
            out.append(Norm(name.lower(), tuple(args)))
    return tuple(out)


# ----------------------------------------------------------------------------------
# field compression (SVD)
# ----------------------------------------------------------------------------------
@dataclass
class Compression:
    """SVD compression of a field quantity to low-rank latent coefficients; the
    projection and reconstruction are matrix products."""

    method: str = "svd"
    rank: Optional[int] = None
    energy_tol: Optional[float] = None
    reconstruction_tol: Optional[float] = 0.01
    fields: Optional[Sequence[str]] = None
    coords: Optional[np.ndarray] = None
    data_matrix: Optional[np.ndarray] = None
    projection: Optional[np.ndarray] = None  # (grid, rank) orthonormal columns

    def compute_map(self, data_matrix=None) -> np.ndarray:
        """The SVD projection map of a ``(grid, snapshots)`` matrix of
        (normalized) field snapshots; defaults to ``self.data_matrix``."""
        from hallthrusterpem_tpu_torch.ops.svd import svd_rank

        A = np.asarray(self.data_matrix if data_matrix is None else data_matrix)
        if A.ndim != 2:
            raise ValueError(f"data_matrix must be 2-D (grid, snapshots); got {A.shape}")
        self.data_matrix = A
        U, r = svd_rank(A, rank=self.rank, energy_tol=self.energy_tol,
                        reconstruction_tol=self.reconstruction_tol)
        self.projection = np.asarray(U[:, :r])
        self.rank = int(r)
        return self.projection

    @property
    def latent_size(self) -> int:
        if self.projection is None:
            raise ValueError("compression map not computed yet; call compute_map()")
        return self.projection.shape[1]

    def _map(self, x):
        return torch.as_tensor(self.projection, dtype=x.dtype, device=x.device)

    def compress(self, fields):
        """``(..., grid)`` fields to ``(..., rank)`` latent coefficients."""
        if isinstance(fields, torch.Tensor):
            return fields @ self._map(fields)
        return np.asarray(fields) @ np.asarray(self.projection)

    def reconstruct(self, latent):
        """``(..., rank)`` latents back to ``(..., grid)`` fields."""
        if isinstance(latent, torch.Tensor):
            return latent @ self._map(latent).T
        return np.asarray(latent) @ np.asarray(self.projection).T

    @staticmethod
    def from_dict(d: dict) -> "Compression":
        return Compression(**{k: v for k, v in d.items() if k in Compression.__dataclass_fields__})


# ----------------------------------------------------------------------------------
# variables
# ----------------------------------------------------------------------------------
@dataclass
class Variable:
    """A named model input or output with category, distribution, domain, norm
    and optional field compression."""

    name: str
    description: str = ""
    category: str = ""  # operating | calibration | nuisance | output (free-form)
    tex: str = ""
    units: str = ""
    nominal: Optional[float] = None
    domain: Optional[tuple[float, float]] = None
    distribution: Optional[Distribution] = None
    norm: tuple[Norm, ...] = field(default_factory=tuple)
    compression: Optional[Compression] = None

    def __post_init__(self):
        self.domain = _parse_domain(self.domain)
        self.distribution = parse_distribution(self.distribution)
        if not isinstance(self.norm, tuple) or (self.norm and not isinstance(self.norm[0], Norm)):
            self.norm = parse_norms(self.norm)

    def normalize(self, x, denorm: bool = False):
        """Apply (or with ``denorm=True`` invert) this variable's norm chain."""
        if denorm:
            return self.denormalize(x)
        for n in self.norm:
            x = n.forward(x)
        return x

    def denormalize(self, y):
        for n in reversed(self.norm):
            y = n.inverse(y)
        return y

    def normalized_domain(self) -> Optional[tuple[float, float]]:
        """The domain in normalized space, ordered low to high."""
        dom = self.get_domain()
        if dom is None:
            return None
        lo, hi = (float(np.asarray(self.normalize(v))) for v in dom)
        return (min(lo, hi), max(lo, hi))

    def get_domain(self) -> Optional[tuple[float, float]]:
        """The variable's domain; the distribution's support when it has none."""
        if self.domain is not None:
            return self.domain
        if self.distribution is not None:
            return self.distribution.bounds(self.nominal)
        return None

    def bounds(self) -> Optional[tuple[float, float]]:
        """Legacy alias of :meth:`get_domain` (the reference's mcmc.py reads it);
        a distribution's own ``bounds(nominal)`` is its support."""
        return self.get_domain()

    def sample_domain(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Uniform draws over the (denormalized) domain, float32 on the CPU."""
        dom = self.get_domain()
        if dom is None:
            raise ValueError(f"Variable {self.name} has no domain to sample")
        return Distribution("uniform", dom).sample(generator, shape)

    def sample(self, generator: torch.Generator, shape, nominal=None) -> torch.Tensor:
        """Draws from the distribution (uniform over the domain without one)."""
        nom = self.nominal if nominal is None else nominal
        if self.distribution is not None:
            return self.distribution.sample(generator, shape, nominal=nom)
        return self.sample_domain(generator, shape)

    def pdf(self, x, nominal: Optional[float] = None):
        nom = self.nominal if nominal is None else nominal
        if self.distribution is not None:
            return self.distribution.pdf(x, nominal=nom)
        dom = self.get_domain()
        xp = _xp(x)
        if dom is None:
            return xp.ones_like(x if xp is torch else np.asarray(x, dtype=float))
        lo, hi = dom
        return _density_on(x if xp is torch else np.asarray(x), lo, hi, 1.0 / (hi - lo))

    @staticmethod
    def from_dict(d: dict) -> "Variable":
        d = dict(d)
        comp = d.pop("compression", None)
        var = Variable(**{k: v for k, v in d.items() if k in Variable.__dataclass_fields__})
        if comp is not None:
            var.compression = comp if isinstance(comp, Compression) else Compression.from_dict(comp)
        return var

    def __eq__(self, other):
        if isinstance(other, Variable):
            return self.name == other.name
        return self.name == other

    def __hash__(self):
        return hash(self.name)

    def __str__(self):
        return self.name

    def get_tex(self, units: bool = False, symbol: bool = True) -> str:
        """Axis label: the TeX symbol (else the name), with the units in brackets."""
        label = self.tex if (symbol and self.tex) else self.name
        if units and self.units:
            label = f"{label} [{self.units}]"
        return label

    def to_tex(self, **kwargs) -> str:
        return self.get_tex(**kwargs)

    @property
    def mu(self):
        """The distribution's mean where it has one, else the nominal."""
        if self.distribution is not None:
            return self.distribution.mu
        return self.nominal

    @property
    def param_type(self) -> str:
        """Legacy category accessor: the category, or 'output' without one."""
        return self.category or "output"
