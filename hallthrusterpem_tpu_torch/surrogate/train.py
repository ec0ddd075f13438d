"""Adaptive multi-fidelity surrogate training: the ``System.fit`` implementation
(the JAX package's ``surrogate/train.py``).

Greedy MISC refinement: each iteration scores every candidate ``(component, alpha,
beta)`` by hierarchical-surplus error indicator per unit model cost, activates the
best one, records ``train_history``, and checkpoints. Model evaluations run as
batched calls on the system's device.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np

from hallthrusterpem_tpu_torch.core.dataset import to_numpy

__all__ = ["fit_system", "relative_l2"]


def relative_l2(pred, ref, axis=None) -> float:
    pred = np.asarray(to_numpy(pred), dtype=np.float64)
    ref = np.asarray(to_numpy(ref), dtype=np.float64)
    mask = np.isfinite(ref) & np.isfinite(pred)
    if not mask.any():
        return float("nan")
    diff = np.where(mask, pred - ref, 0.0)
    den = np.sqrt(np.sum(np.where(mask, ref**2, 0.0), axis=axis))
    num = np.sqrt(np.sum(diff**2, axis=axis))
    return float(np.mean(num / np.maximum(den, 1e-30)))


def _test_errors(system, test_set, targets) -> dict:
    """Relative-L2 per target on a (samples, outputs) test set."""
    if test_set is None:
        return {}
    xt, yt = test_set if isinstance(test_set, tuple) else (test_set["xt"], test_set["yt"])
    pred = system.predict(xt, use_model=None, training=True)
    errors = {}
    for target in targets or yt.keys():
        if target not in yt or target not in pred:
            continue
        ref_val = np.asarray(to_numpy(yt[target]), dtype=np.float64)
        got = np.asarray(to_numpy(pred[target]), dtype=np.float64)
        # field outputs come back as latent coefficients: reconstruct
        if got.shape != ref_val.shape:
            for comp in system.components:
                if comp.surrogate is None:
                    continue
                try:
                    got = np.asarray(comp.surrogate.reconstruct_field(target, got))
                    break
                except KeyError:
                    continue
        if got.shape != ref_val.shape:
            continue
        errors[target] = relative_l2(got, ref_val, axis=-1 if ref_val.ndim > 1 else None)
    return errors


def fit_system(
    system,
    targets=None,
    max_iter: int = 100,
    max_tol: float = 1e-3,
    runtime_hr: Optional[float] = None,
    num_refine: int = 256,
    test_set=None,
    save_interval: int = 0,
    cache_interval: int = 0,
    estimate_bounds: bool = False,
    update_bounds: bool = False,
    executor=None,
    weight_fcns=None,
    plot_interval: int = 0,
    verbose: bool = True,
    seed: int = 0,
):
    """Adaptively refine all component surrogates. Returns ``system.train_history``.

    ``weight_fcns``, ``plot_interval`` and ``executor`` are accepted and unused,
    as in the JAX package (model evaluations are single batched calls).
    ``cache_interval`` persists the component model-evaluation caches every N
    iterations (:meth:`System.load_training_cache` restores them).
    """
    from hallthrusterpem_tpu_torch.surrogate.component import ComponentSurrogate

    rng = np.random.default_rng(seed)
    t_start = time.time()

    # estimate/refresh output-variable domains from the test set
    if (estimate_bounds or update_bounds) and test_set is not None:
        xt, yt = test_set if isinstance(test_set, tuple) else (test_set["xt"], test_set["yt"])
        for comp in system.components:
            for var in comp.outputs:
                if var.name in yt:
                    arr = np.asarray(to_numpy(yt[var.name]), dtype=np.float64)
                    finite = arr[np.isfinite(arr)]
                    if finite.size and (var.domain is None or update_bounds):
                        var.domain = (float(finite.min()), float(finite.max()))

    # initialize surrogates (a surrogate pre-created by load_training_cache
    # carries eval caches but no active set — it still needs initialize())
    for comp in system.components:
        if comp.surrogate is None:
            comp.surrogate = ComponentSurrogate(comp, device=system.device)
        if not comp.surrogate.active:
            n0 = comp.surrogate.initialize()
            if verbose:
                system.logger.info("Initialized surrogate for %s (%d evals)", comp.name, n0)

    def _checkpoint(i):
        if system.root_dir is None:
            return
        save_dir = Path(system.root_dir) / "surrogates" / f"{system.name}_iter{i}"
        save_dir.mkdir(parents=True, exist_ok=True)
        system.save_to_file(f"{system.name}_iter{i}.json", save_dir)

    def _cache_training_data():
        """Persist the per-component model-evaluation caches mid-fit so an
        interrupted run's model evals survive independently of checkpoints."""
        if system.root_dir is None:
            return
        cache_dir = Path(system.root_dir) / "cache"
        cache_dir.mkdir(parents=True, exist_ok=True)
        payload = {
            comp.name: {"eval_cache": comp.surrogate.eval_cache,
                        "model_costs": dict(comp.model_costs),
                        "repaired": {a: sorted(s) for a, s in comp.surrogate._repaired_keys.items()}}
            for comp in system.components if comp.surrogate is not None
        }
        with open(cache_dir / f"{system.name}_training_cache.pkl", "wb") as f:
            pickle.dump(payload, f)

    coupling_names = {v.name for v in system.coupling_vars}

    stall = 0
    best_err_seen = float("inf")
    stall_window = 10

    for iteration in range(int(max_iter)):
        t_iter = time.perf_counter()
        best = None  # (indicator, comp, kappa, err, n_new)
        best_alpha_adv = None  # best alpha-advancing candidate by RAW error
        n_prefetched = 0
        for comp in system.components:
            surr = comp.surrogate
            out_cols = surr.output_mask(targets, coupling_names)
            if out_cols is None or len(out_cols):
                # one batched model call per alpha for every candidate's missing
                # grid points, instead of one call per candidate
                n_prefetched += surr.prefetch_candidate_evals(surr.candidates)
            active_alphas = {k[: surr.n_alpha] for k in surr.active}
            for kappa in sorted(surr.candidates):
                err, n_new, cost = surr.candidate_surplus(kappa, num_refine=num_refine, rng=rng, out_cols=out_cols)
                # cost-aware greedy with a softened exponent: pure err/cost starves
                # expensive components forever when cheap analytic ones coexist
                indicator = err / max(cost, 1e-3) ** 0.5
                if best is None or indicator > best[0]:
                    best = (indicator, comp, kappa, err, n_new)
                if surr.n_alpha and kappa[: surr.n_alpha] not in active_alphas:
                    if best_alpha_adv is None or err > best_alpha_adv[0]:
                        best_alpha_adv = (err, comp, kappa, n_new)
        if best is None or best[0] <= 0.0:
            if verbose:
                system.logger.info("No informative candidates left; refinement stops.")
            break

        # stagnation escape: when the targeted test error has not improved over
        # the last `stall_window` activations, force the best model-fidelity
        # (alpha) advance by raw error, ignoring cost
        if stall >= stall_window and best_alpha_adv is not None and best_alpha_adv[0] > 0:
            err_a, comp_a, kappa_a, n_new_a = best_alpha_adv
            best = (float("inf"), comp_a, kappa_a, err_a, n_new_a)
            stall = stall_window // 2  # give the new level a few iterations to build out
            if verbose:
                system.logger.info("stagnation escape: forcing alpha advance %s on %s (raw err %.3e)",
                                   kappa_a[: comp_a.surrogate.n_alpha], comp_a.name, err_a)

        _, comp, kappa, err, n_new = best
        surr = comp.surrogate
        alpha, beta = kappa[: surr.n_alpha], kappa[surr.n_alpha :]
        surr.activate_index(kappa)
        overhead = time.perf_counter() - t_iter

        errors = _test_errors(system, test_set, targets)
        record = {
            "iteration": iteration,
            "component": comp.name,
            "alpha": tuple(alpha),
            "beta": tuple(beta),
            "error_indicator": err,
            "num_evals": n_new + n_prefetched,
            "test_error": errors,
            "overhead_s": overhead,
        }
        system.train_history.append(record)
        if verbose:
            system.logger.info("iter %d: activate %s alpha=%s beta=%s surplus=%.3e evals=%d test=%s",
                               iteration, comp.name, alpha, beta, err, n_new,
                               {k: f"{v:.3e}" for k, v in errors.items()})

        # periodic re-imputation of the failed knots of active interpolants
        # against the current (better) surface
        if (iteration + 1) % 25 == 0:
            n_reimp = sum(c.surrogate.reimpute_active() for c in system.components if c.surrogate)
            if n_reimp and verbose:
                system.logger.info("re-imputed failed knots in %d interpolants", n_reimp)

        if save_interval and (iteration + 1) % save_interval == 0:
            _checkpoint(iteration + 1)
        if cache_interval and (iteration + 1) % cache_interval == 0:
            _cache_training_data()

        if errors:
            cur = max(errors.values())
            if cur < best_err_seen * 0.99:
                best_err_seen = cur
                stall = 0
            else:
                stall += 1

        if errors and max(errors.values()) < max_tol:
            if verbose:
                system.logger.info("Converged: max test error %.3e < %.1e", max(errors.values()), max_tol)
            break
        if runtime_hr is not None and (time.time() - t_start) > runtime_hr * 3600:
            if verbose:
                system.logger.info("Runtime budget reached.")
            break

    _checkpoint(len(system.train_history))
    return system.train_history
