"""Per-component adaptive multi-fidelity sparse-grid surrogate (the JAX package's
``surrogate/component.py``).

Nested Leja tensor grids per ``(alpha, beta)`` multi-index, MISC combination over
a downward-closed active set, cost-aware greedy refinement driven by
hierarchical-surplus error indicators. The bookkeeping (evaluation cache, NaN
repair, surplus, activation, re-imputation) is numpy on the host; model
evaluations are one batched ``call_model`` per fidelity on the surrogate's
device (a CUDA device unless ``device="cpu"`` is given), and
:meth:`ComponentSurrogate.as_torch_fn` evaluates the frozen combination there.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from hallthrusterpem_tpu_torch.core.dataset import Dataset, as_numpy, to_numpy
from hallthrusterpem_tpu_torch.ops.interp import interp1d
from hallthrusterpem_tpu_torch.surrogate.interpolate import TensorInterpolant, eval_tensor, tensor_grid_points
from hallthrusterpem_tpu_torch.surrogate.knots import knots_for_level
from hallthrusterpem_tpu_torch.surrogate.misc import (
    candidate_neighbors,
    combination_coefficients,
    split_index,
)
from hallthrusterpem_tpu_torch.utils import resolve_device

__all__ = ["ComponentSurrogate", "regrid_to_compression"]


def regrid_to_compression(var, val: np.ndarray, model_coords) -> np.ndarray:
    """A field sampled on the model's grid (``{var}_coords``) interpolated onto
    its compression map's grid when the two differ, in float32 as the JAX
    package does; ``val`` unchanged otherwise."""
    comp_coords = var.compression.coords
    if comp_coords is None or model_coords is None or val.shape[-1] == np.asarray(comp_coords).shape[-1]:
        return val
    mc = np.asarray(model_coords, dtype=np.float64)
    f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    return interp1d(f32(comp_coords), f32(mc[0] if mc.ndim > 1 else mc), f32(val)).numpy()


class ComponentSurrogate:
    def __init__(self, component, knots_per_level: Optional[int] = None, device=None):
        self.component = component
        self.device = resolve_device(device)
        td = component.training_data or {}
        if td.get("method", "sparse-grid") != "sparse-grid":
            raise ValueError(f"Unsupported training_data method {td.get('method')!r}")
        self.knots_per_level = int(knots_per_level or td.get("knots_per_level", 2))
        #: per-dim basis: "lagrange" (spectral) or "linear" (local hats — robust
        #: when the model has extreme-but-finite responses at domain corners)
        self.interpolation = str(td.get("interpolation", "lagrange"))

        self.inputs = list(component.inputs)
        self.n_dim = len(self.inputs)
        self.alpha_max = tuple(component.model_fidelity)
        beta_max = tuple(component.data_fidelity)
        if not beta_max:
            beta_max = (2,) * self.n_dim
        if len(beta_max) != self.n_dim:
            raise ValueError(
                f"data_fidelity has {len(beta_max)} dims but component {component.name} has {self.n_dim} inputs"
            )
        self.beta_max = beta_max
        self.n_alpha = len(self.alpha_max)

        # normalized input domains (surrogate space)
        self.domains = []
        for v in self.inputs:
            dom = v.normalized_domain()
            if dom is None:
                raise ValueError(f"Variable {v.name} needs a domain/distribution for surrogate training")
            self.domains.append(dom)

        # output layout: (var, start, size, kind) per output variable
        self.outputs = list(component.outputs)
        self._out_slices: list[tuple] = []
        self._layout_built = False

        self.interpolants: dict[tuple, TensorInterpolant] = {}  # kappa -> interpolant
        self.nan_frac: dict[tuple, float] = {}  # kappa -> fraction of failed grid evals
        self.active: set = set()
        self.candidates: set = set()
        self.eval_cache: dict[tuple, dict[tuple, np.ndarray]] = {}  # alpha -> {point: out_vec}
        self.misc_coeff: dict[tuple, int] = {}
        #: per alpha, the cached points whose values are NaN-imputed
        self._repaired_keys: dict[tuple, set] = {}
        self._coeff_cache: dict[frozenset, dict] = {}

    # ------------------------------------------------------------------ layout
    def _build_layout(self, raw=None):
        """Output layout: each output var maps to a column block. ``kind`` is
        'scalar', 'latent' (SVD-compressed field), or 'raw' (uncompressed field —
        every grid point is its own surrogate output). Raw-field sizes are
        inferred from the first model evaluation."""
        if self._layout_built:
            return
        start = 0
        self._out_slices = []
        for var in self.outputs:
            if var.compression is not None and var.compression.projection is not None:
                size, kind = var.compression.latent_size, "latent"
            else:
                size, kind = 1, "scalar"
                if raw is not None and var.name in raw:
                    val = np.asarray(raw[var.name])
                    if val.ndim >= 2:  # (batch, grid, ...) field without compression
                        size, kind = int(np.prod(val.shape[1:])), "raw"
            self._out_slices.append((var, start, size, kind))
            start += size
        self.n_out = start
        # only a layout inferred from real model output is final (raw-field sizes
        # cannot be known from the spec alone)
        self._layout_built = raw is not None

    # ------------------------------------------------------------------ grids
    def knots_1d(self, beta: tuple) -> list[np.ndarray]:
        return [
            knots_for_level(b, self.knots_per_level, domain=self.domains[d])
            for d, b in enumerate(beta)
        ]

    def _denormalize_points(self, pts: np.ndarray) -> dict:
        """(N, d) normalized grid points -> model-unit input dict (numpy)."""
        return {var.name: np.asarray(var.denormalize(pts[:, d])) for d, var in enumerate(self.inputs)}

    def _pack_outputs(self, raw: dict, n: int) -> np.ndarray:
        """Model outputs -> (N, n_out) normalized/compressed value matrix."""
        self._build_layout(raw)
        cols = np.empty((n, self.n_out), dtype=np.float64)
        for var, start, size, kind in self._out_slices:
            val = np.asarray(raw[var.name], dtype=np.float64)
            if kind == "latent":
                # re-grid onto the compression coordinates when the model fidelity
                # changed the output grid; project in float32, as the JAX package
                val = regrid_to_compression(var, val, raw.get(f"{var.name}_coords"))
                norm = np.asarray(var.normalize(val))
                lat = var.compression.compress(torch.as_tensor(norm, dtype=torch.float32)).numpy()
                cols[:, start : start + size] = lat.reshape(n, size)
            else:  # scalar or raw field
                # physically absurd (but finite) values are treated as failures:
                # outside 5x the declared output range they would poison the
                # interpolant
                dom = var.get_domain()
                if dom is not None and kind == "scalar":
                    lo, hi = dom
                    width = max(hi - lo, 1e-30)
                    val = np.where((val < lo - 5 * width) | (val > hi + 5 * width), np.nan, val)
                norm = np.asarray(var.normalize(val))
                cols[:, start : start + size] = norm.reshape(n, size)
        return cols

    def unpack_outputs(self, mat, denormalize: bool = True) -> Dataset:
        """(..., n_out) value matrix (numpy or tensor) -> named outputs. Scalars
        and raw fields are denormalized; compressed fields come back as latent
        coefficient arrays (reconstruct with :meth:`reconstruct_field`)."""
        self._build_layout()
        out = {}
        for var, start, size, kind in self._out_slices:
            block = mat[..., start : start + size]
            if kind == "latent":
                out[var.name] = block  # latent coefficients (normalized space)
            elif kind == "raw":
                out[var.name] = var.denormalize(block) if denormalize else block
            else:
                scalar = block[..., 0]
                if denormalize:
                    scalar = var.denormalize(scalar)
                    dom = var.get_domain()
                    if dom is not None:
                        # tame polynomial extrapolation: clip to a generous band
                        # around the declared physical range
                        lo, hi = dom
                        width = max(hi - lo, 1e-30)
                        clip = torch.clamp if isinstance(scalar, torch.Tensor) else np.clip
                        scalar = clip(scalar, lo - width, hi + width)
                out[var.name] = scalar
        return out

    def reconstruct_field(self, var_name: str, latents):
        """Latent coefficients -> denormalized field profile."""
        for var, start, size, kind in self._out_slices:
            if var.name == var_name and kind == "latent":
                return var.denormalize(var.compression.reconstruct(latents))
        raise KeyError(f"{var_name} is not a compressed field output of {self.component.name}")

    # ------------------------------------------------------------------ training
    def _point_key(self, pt: np.ndarray) -> tuple:
        return tuple(np.round(np.asarray(pt, dtype=np.float64), 12))

    def evaluate_points(self, alpha: tuple, pts: np.ndarray) -> tuple[np.ndarray, int]:
        """Model values at (N, d) normalized points, via cache + one batched call
        on the surrogate's device for the misses. Returns (values (N, n_out),
        num_new_evals)."""
        cache = self.eval_cache.setdefault(alpha, {})
        keys = [self._point_key(p) for p in pts]
        # until a model output has fixed the layout (an uncompressed field's
        # width comes from the data), cached values cannot be read: a surrogate
        # restored from a training cache evaluates its first points anew (the
        # JAX package reads them with a scalar's width and fails)
        missing = [i for i, k in enumerate(keys) if k not in cache or not self._layout_built]
        n_bad = 0
        if missing:
            # float32 inputs, as the JAX package's models compute
            batch = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                     for k, v in self._denormalize_points(pts[missing]).items()}
            raw = as_numpy(self.component.call_model(batch, model_fidelity=alpha if alpha else None,
                                                     device=self.device))
            vals = self._pack_outputs(raw, len(missing))
            # NaN repair: failed samples take the column median of valid rows
            # (interpolation needs every knot); the count of repaired rows feeds
            # the refinement penalty
            bad = ~np.isfinite(vals)
            if bad.any():
                n_bad = int((~np.isfinite(vals).all(axis=1)).sum())
                with np.errstate(all="ignore"), warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN columns -> repaired below
                    med = np.nanmedian(np.where(np.isfinite(vals), vals, np.nan), axis=0)
                med = np.where(np.isfinite(med), med, 0.0)
                # remember which cached rows are imputed so the fidelity-ladder
                # look-ahead can exclude them from gap math
                rep_set = self._repaired_keys.setdefault(alpha, set())
                for i in np.nonzero(bad.any(axis=1))[0]:
                    rep_set.add(keys[missing[i]])
                vals = np.where(bad, np.broadcast_to(med, vals.shape), vals)
            for i, vi in zip(missing, vals):
                cache[keys[i]] = vi
        out = np.stack([cache[k] for k in keys], axis=0)
        self._last_nan_frac = n_bad / max(len(missing), 1) if missing else 0.0
        return out, len(missing)

    def build_interpolant(self, kappa: tuple) -> tuple[TensorInterpolant, int]:
        alpha, beta = split_index(kappa, self.n_alpha)
        knots = self.knots_1d(beta)
        pts = tensor_grid_points(knots)
        vals, n_new = self.evaluate_points(alpha, pts)
        # zero-surplus imputation: failed (NaN-repaired) knots take the CURRENT
        # active combination's prediction there, so the new index contributes
        # nothing where the model gave no signal
        rep_keys = self._repaired_keys.get(alpha, set())
        if rep_keys and self.active:
            bad_rows = [i for i, p in enumerate(pts) if self._point_key(p) in rep_keys]
            if bad_rows:
                vals = vals.copy()
                vals[bad_rows] = self._combined_eval(pts[bad_rows], self.active)
        shape = tuple(len(k) for k in knots) + (vals.shape[-1],)
        interp = TensorInterpolant(knots=tuple(knots), values=vals.reshape(shape), method=self.interpolation)
        self.interpolants[kappa] = interp
        # failed-knot fraction over the WHOLE grid (cached repaired points
        # included), not just this call's misses
        if rep_keys:
            keys = [self._point_key(p) for p in pts]
            self.nan_frac[kappa] = sum(k in rep_keys for k in keys) / max(len(keys), 1)
        else:
            self.nan_frac[kappa] = 0.0
        return interp, n_new

    def prefetch_candidate_evals(self, kappas) -> int:
        """Evaluate ALL missing grid points across the candidate index-sets in
        one batched model call per alpha (a batched solve of a few hundred
        points costs the card about what one point does). Returns the number of
        new model evaluations."""
        by_alpha: dict[tuple, dict[tuple, np.ndarray]] = {}
        for kappa in kappas:
            if kappa in self.interpolants:
                continue
            alpha, beta = split_index(kappa, self.n_alpha)
            cache = self.eval_cache.setdefault(alpha, {})
            dst = by_alpha.setdefault(alpha, {})
            for p in tensor_grid_points(self.knots_1d(beta)):
                k = self._point_key(p)
                if k not in cache and k not in dst:
                    dst[k] = p
        n = 0
        for alpha, pending in by_alpha.items():
            if pending:
                _, n_new = self.evaluate_points(alpha, np.stack(list(pending.values())))
                n += n_new
        return n

    def initialize(self) -> int:
        """Activate the base index (all zeros). Returns number of model evals."""
        kappa0 = (0,) * (self.n_alpha + self.n_dim)
        _, n_new = self.build_interpolant(kappa0)
        self.active.add(kappa0)
        self._refresh_candidates()
        self.misc_coeff = combination_coefficients(self.active)
        return n_new

    def _refresh_candidates(self):
        max_levels = list(self.alpha_max) + list(self.beta_max)
        self.candidates = candidate_neighbors(self.active, max_levels)

    def output_mask(self, targets=None, coupling_names=()) -> Optional[np.ndarray]:
        """Column indices of outputs that matter for refinement: targeted outputs
        plus coupling outputs that feed downstream components. None = all
        outputs; empty array = this component does not influence any target."""
        if targets is None or not self._layout_built:
            return None
        wanted = set(targets) | set(coupling_names)
        cols: list[int] = []
        for var, start, size, _ in self._out_slices:
            if var.name in wanted:
                cols.extend(range(start, start + size))
        return np.asarray(cols, dtype=int)

    def _variable_blocks(self, out_cols=None) -> Optional[list]:
        """Column-index blocks, one per output variable (a field's latent columns
        form a single block), optionally intersected with ``out_cols``. None when
        the output layout is not built yet (no model eval has happened)."""
        if not self._layout_built:
            return None
        sel = None if out_cols is None else {int(c) for c in np.asarray(out_cols).ravel()}
        blocks = []
        for _var, start, size, _kind in self._out_slices:
            cols = [c for c in range(start, start + size) if sel is None or c in sel]
            if cols:
                blocks.append(np.asarray(cols, dtype=int))
        return blocks or None

    def candidate_surplus(
        self, kappa: tuple, num_refine: int = 256, rng=None, out_cols=None
    ) -> tuple[float, int, float]:
        """Error indicator for activating ``kappa``: relative change of the
        combined surrogate on random test points, per unit model cost.

        Returns (error_indicator, num_new_evals, cost_seconds_estimate).
        """
        if out_cols is not None and len(out_cols) == 0:
            return 0.0, 0, 1.0  # component influences no target: never refine
        if kappa not in self.interpolants:
            _, n_new = self.build_interpolant(kappa)
        else:
            n_new = 0
        rng = rng or np.random.default_rng(0)
        x = np.stack([rng.uniform(lo, hi, num_refine) for (lo, hi) in self.domains], axis=-1)
        cur = self._combined_eval(x, self.active)
        new = self._combined_eval(x, self.active | {kappa})
        # scale-free, bounded surplus per output VARIABLE: ||new-cur|| / (||cur||
        # + ||new||), a field's latent columns as one block, so that a many-latent
        # field does not outvote the scalars
        blocks = self._variable_blocks(out_cols)

        def _bounded_rel(a, b):
            if blocks is None:  # layout not built yet: per-column fallback
                sel = slice(None) if out_cols is None else out_cols
                a, b = a[:, sel], b[:, sel]
                num = np.linalg.norm(a - b, axis=0)
                denom = np.linalg.norm(a, axis=0) + np.linalg.norm(b, axis=0) + 1e-12
                return float(np.mean(num / denom))
            vals = []
            for cols in blocks:
                num = np.linalg.norm(a[:, cols] - b[:, cols])
                den = np.linalg.norm(a[:, cols]) + np.linalg.norm(b[:, cols]) + 1e-12
                vals.append(num / den)
            return float(np.mean(vals))

        err = _bounded_rel(new, cur)
        alpha, _ = split_index(kappa, self.n_alpha)

        # fidelity-ladder look-ahead: a first-time alpha advance is scored by the
        # raw model-vs-model gap over (up to 8) existing training inputs; the
        # evals are cached under the new alpha and reused when it activates
        active_alphas = {split_index(k, self.n_alpha)[0] for k in self.active}
        probe_fail = 0.0
        if self.n_alpha and alpha not in active_alphas:
            src_alpha = max(active_alphas, key=lambda a: len(self.eval_cache.get(a, {})))
            src_cache = self.eval_cache.get(src_alpha, {})
            if src_cache:
                keys = sorted(src_cache, key=hash)[:8]  # deterministic, spread
                pts_gap = np.asarray(keys, dtype=np.float64)
                vals_new, n2 = self.evaluate_points(alpha, pts_gap)
                n_new += n2
                # the gap over clean probes only; the failure penalty counts only
                # probes clean at the source alpha that fail at the candidate
                rep_new = self._repaired_keys.get(alpha, set())
                rep_src = self._repaired_keys.get(src_alpha, set())
                clean_src = [j for j, k in enumerate(keys) if k not in rep_src]
                ok = [j for j in clean_src if keys[j] not in rep_new]
                probe_fail = 1.0 - len(ok) / max(len(clean_src), 1)
                if ok:
                    vals_new = vals_new[ok]
                    vals_ref = np.stack([src_cache[keys[j]] for j in ok], axis=0)
                    err = max(err, _bounded_rel(vals_new, vals_ref))

        # candidates whose model evals fail more often than the active set's are
        # de-prioritized in proportion to the excess, with a floor; total failure
        # is a hard veto
        own_frac = max(self.nan_frac.get(kappa, 0.0), probe_fail)
        if own_frac >= 0.99:
            return 0.0, n_new, max(n_new, 1) * self.component.get_cost(alpha)
        base_frac = max([self.nan_frac.get(k, 0.0) for k in self.active], default=0.0)
        excess = max(0.0, own_frac - base_frac)
        err *= max(0.1, 1.0 - 2.0 * excess)
        cost = max(n_new, 1) * self.component.get_cost(alpha)
        return err, n_new, cost

    def activate_index(self, kappa: tuple):
        # re-impute failed knots at activation time with the current combination
        # (the candidate may have been built many activations earlier); all model
        # evals come from the cache
        alpha, beta = split_index(kappa, self.n_alpha)
        rep = self._repaired_keys.get(alpha, set())
        if kappa in self.interpolants and rep:
            pts = tensor_grid_points(self.knots_1d(beta))
            if any(self._point_key(p) in rep for p in pts):
                del self.interpolants[kappa]
        if kappa not in self.interpolants:
            self.build_interpolant(kappa)
        self.active.add(kappa)
        self.misc_coeff = combination_coefficients(self.active)
        self._refresh_candidates()

    def reimpute_active(self) -> int:
        """Re-impute the failed knots of every ACTIVE interpolant with the
        current combined surface, the imputation values all frozen from the full
        active combination before any rebuild (the active set is never changed,
        which would break the MISC telescoping). Returns the number rebuilt; all
        model values come from the eval cache."""
        if not self._repaired_keys:
            return 0
        todo = []
        for kappa in sorted(self.active, key=lambda k: (sum(k), k)):
            alpha, beta = split_index(kappa, self.n_alpha)
            rep = self._repaired_keys.get(alpha, set())
            if not rep:
                continue
            pts = tensor_grid_points(self.knots_1d(beta))
            bad = [i for i, p in enumerate(pts) if self._point_key(p) in rep]
            if bad:
                todo.append((kappa, alpha, beta, pts, np.asarray(bad)))
        if not todo:
            return 0
        frozen = {kappa: self._combined_eval(pts[bad], self.active) for kappa, _, _, pts, bad in todo}
        for kappa, alpha, beta, pts, bad in todo:
            knots = self.knots_1d(beta)
            vals, _ = self.evaluate_points(alpha, pts)
            vals = vals.copy()
            vals[bad] = frozen[kappa]
            shape = tuple(len(k) for k in knots) + (vals.shape[-1],)
            self.interpolants[kappa] = TensorInterpolant(
                knots=tuple(knots), values=vals.reshape(shape), method=self.interpolation
            )
        return len(todo)

    # ------------------------------------------------------------------ prediction
    def _combined_eval(self, x: np.ndarray, index_set) -> np.ndarray:
        self._build_layout()
        coeffs = self._coeffs_cached(index_set)
        total = np.zeros((x.shape[0], self.n_out))
        for kappa, c in coeffs.items():
            total += c * np.asarray(self.interpolants[kappa](x))
        return total

    def predict(self, inputs: Dataset, training: bool = False, denormalize: bool = True) -> dict:
        """Evaluate the surrogate on a batch of model-unit inputs, in numpy on the
        host (float64).

        :param training: use only the active set; otherwise include the candidate
            indices that have interpolants too.
        """
        cols = []
        batch_shape = None
        for v in self.inputs:
            arr = np.asarray(to_numpy(inputs[v.name]), dtype=np.float64)
            batch_shape = arr.shape if batch_shape is None else batch_shape
            cols.append(np.ravel(np.asarray(v.normalize(arr))))
        x = np.stack(cols, axis=-1)

        index_set = self.active if training else (self.active | self.candidates_with_interp())
        coeffs = self._coeffs_cached(index_set)
        total = None
        for kappa, c in coeffs.items():
            val = np.asarray(self.interpolants[kappa](x)) * c
            total = val if total is None else total + val
        total = total.reshape(batch_shape + (self.n_out,))
        return self.unpack_outputs(total, denormalize=denormalize)

    def as_torch_fn(self, training: bool = True, denormalize: bool = True):
        """A pure ``fn(inputs) -> outputs`` on tensors that evaluates the frozen
        MISC combination on the surrogate's device, in float32 (as the JAX
        package's ``as_jax_fn``). The host :meth:`predict` stays numpy."""
        index_set = self.active if training else (self.active | self.candidates_with_interp())
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)
        items = [
            (tuple(f32(k) for k in self.interpolants[kappa].knots),
             tuple(f32(w) for w in self.interpolants[kappa]._weights),
             f32(self.interpolants[kappa].values), float(c))
            for kappa, c in self._coeffs_cached(index_set).items()
        ]
        in_vars = list(self.inputs)
        self._build_layout()

        def fn(inputs: Dataset) -> Dataset:
            cols = [v.normalize(torch.as_tensor(inputs[v.name], dtype=torch.float32, device=self.device)).reshape(-1)
                    for v in in_vars]
            batch_shape = tuple(np.shape(inputs[in_vars[0].name]))
            x = torch.stack(cols, dim=-1)
            total = None
            for knots, weights, values, c in items:
                val = eval_tensor(knots, weights, values, x, method=self.interpolation) * c
                total = val if total is None else total + val
            return self.unpack_outputs(total.reshape(batch_shape + (self.n_out,)), denormalize=denormalize)

        return fn

    as_jax_fn = as_torch_fn  # the JAX package's name, for code written against it

    def candidates_with_interp(self) -> set:
        return {k for k in self.candidates if k in self.interpolants}

    def _coeffs_cached(self, index_set) -> dict:
        key = frozenset(index_set)
        if key not in self._coeff_cache:
            if len(self._coeff_cache) > 256:
                self._coeff_cache.clear()
            self._coeff_cache[key] = combination_coefficients(key)
        return self._coeff_cache[key]

    # ------------------------------------------------------------------ persistence
    def to_state(self) -> dict:
        """The surrogate as numpy arrays and Python values, in the JAX package's
        layout (either package's ``from_state`` reads it)."""
        return {
            "knots_per_level": self.knots_per_level,
            "layout": [(var.name, start, size, kind) for var, start, size, kind in self._out_slices]
            if self._layout_built else None,
            "active": sorted(self.active),
            "candidates": sorted(self.candidates),
            "interp": {
                k: {"knots": [np.asarray(q) for q in v.knots], "values": np.asarray(v.values)}
                for k, v in self.interpolants.items()
            },
            "eval_cache": self.eval_cache,
            # which cached points are NaN-imputed, per alpha — without this a
            # restored fit would treat imputed rows as real model data
            "repaired": {a: sorted(s) for a, s in self._repaired_keys.items()},
        }

    @staticmethod
    def from_state(state: dict, component, device=None) -> "ComponentSurrogate":
        surr = ComponentSurrogate(component, knots_per_level=state["knots_per_level"], device=device)
        surr.active = set(tuple(k) for k in state["active"])
        surr.candidates = set(tuple(k) for k in state["candidates"])
        for k, v in state["interp"].items():
            surr.interpolants[tuple(k)] = TensorInterpolant(
                knots=tuple(v["knots"]), values=v["values"], method=surr.interpolation
            )
        surr.eval_cache = state.get("eval_cache", {})
        if state.get("repaired"):
            surr._repaired_keys = {a: set(map(tuple, s)) for a, s in state["repaired"].items()}
        layout = state.get("layout")
        if layout:
            by_name = {v.name: v for v in surr.outputs}
            surr._out_slices = [(by_name[n], start, size, kind) for (n, start, size, kind) in layout]
            surr.n_out = sum(size for (_, _, size, _) in layout)
            surr._layout_built = True
        surr.misc_coeff = combination_coefficients(surr.active)
        return surr
