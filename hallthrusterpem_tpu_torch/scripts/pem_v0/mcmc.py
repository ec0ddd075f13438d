"""Bayesian calibration of the PEM v0 calibration parameters by MCMC (the JAX
package's ``scripts/pem_v0/mcmc.py``).

Gaussian log-likelihood over V_cc / thrust / I_d (with an extra weight on the
discharge-current misfit) and the u_ion / j_ion fields, priors from the
calibration variables' pdfs, optional MLE start and Laplace preconditioning,
DRAM or stretch-move chains written to ``.npz``, IAC/ESS diagnostics.

The log-posterior of a trained surrogate is one PyTorch function over the
whole walker ensemble on the system's device (:func:`build_device_posterior`):
one surrogate call for every walker, noise sample and operating condition per
MCMC half-step. ``--use-model best`` (the true model, which has no torch
function) evaluates it with one batched ``System.predict`` per call and the
likelihood in numpy on the host.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.pem_v0.mcmc pem_v0_SPT-100_trained.json \\
      --data spt100 --qois V_cc T I_d u_ion j_ion --sampler stretch --walkers 64 --niter 20000
(with no --data, a synthetic dataset is generated from the model at nominal
calibration values, a self-consistency check). After the chain, the corner plot
``mcmc_corner.png`` and the posterior predictive ``mcmc_predictive.png`` are
saved into the working directory where matplotlib is installed (best-effort:
without it the plots are skipped with a note).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from hallthrusterpem_tpu_torch import cuda_graph
from hallthrusterpem_tpu_torch.core.dataset import to_numpy
from hallthrusterpem_tpu_torch.core.json_loader import find_latest_save
from hallthrusterpem_tpu_torch.core.system import System
from hallthrusterpem_tpu_torch.ops.interp import interp1d
from hallthrusterpem_tpu_torch.scripts.pem_v0.dataset_util import field_profiles, load_experiment
from hallthrusterpem_tpu_torch.surrogate.mlp import full_fp32
from hallthrusterpem_tpu_torch.uq import (dram, ess, integrated_autocorr_time, laplace_approximation,
                                          normal_sample, run_mle, stretch)

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("config_file")
parser.add_argument("--search", action="store_true", help="use the newest save under the config's directory")
parser.add_argument("--data", nargs="*", default=None,
                    help="experimental CSV files, or the keyword 'spt100' for the bundled datasets")
parser.add_argument("--niter", type=int, default=10000)
parser.add_argument("--walkers", type=int, default=8)
parser.add_argument("--use-model", default=None, help="'best' for the true model; default the surrogate")
parser.add_argument("--noise-std", type=float, default=0.02, help="relative data noise (1-sigma)")
parser.add_argument("--noise-samples", type=int, default=1,
                    help="M operating-condition/nuisance noise samples marginalized per "
                         "likelihood evaluation by logsumexp; 1 = off")
parser.add_argument("--file", default="dram_chain.npz", help="the .npz file the chains are appended to")
parser.add_argument("--mle", action="store_true", help="run MLE optimization first")
parser.add_argument("--laplace", action="store_true",
                    help="precondition with the Laplace approximation at the start point (the MAP "
                         "with --mle): proposal cov0 = (2.38^2/d) * Sigma_Laplace and walker starts "
                         "~ N(x_map, Sigma)")
parser.add_argument("--qois", nargs="*", default=["V_cc", "T", "I_d"],
                    help="QoIs of the likelihood; u_ion / j_ion add the field terms")
parser.add_argument("--field-weight", type=float, default=1.0,
                    help="multiplier on the field (u_ion/j_ion) log-likelihood blocks; ~0.2 weights "
                         "the ~228 field points and the ~41 scalar observations about equally")
parser.add_argument("--id-penalty", type=float, default=2.0,
                    help="extra weight on the discharge-current misfit")
parser.add_argument("--sampler", choices=["dram", "stretch"], default="dram",
                    help="dram = delayed-rejection adaptive Metropolis; stretch = affine-invariant "
                         "ensemble (tuning-free, walker-batched)")
parser.add_argument("--device", default=None, help="torch device of the system (default: the CUDA card)")


def load_system(args) -> System:
    path = find_latest_save(args.config_file) if args.search else Path(args.config_file)
    system = System.load_from_file(path, device=args.device)
    system.set_logger(stdout=True)
    return system


def _nominal(v) -> float:
    return float(v.nominal if v.nominal is not None else 0.5 * sum(v.get_domain()))


def build_dataset(system, args):
    """(operating-conditions dict-of-arrays, scalar observations, scalar sigmas,
    field observations); see :mod:`.dataset_util` for the experimental path."""
    if args.data:
        return load_experiment(args.data, args.qois)

    # synthetic self-consistency dataset: the model at nominal calibration values
    ops = {
        "P_b": np.array([3e-6, 1e-5, 3e-5, 5e-5]),
        "V_a": np.full(4, 300.0),
        "mdot_a": np.full(4, 5e-6),
    }
    samples = {v.name: ops[v.name] if v.name in ops else np.full(4, _nominal(v)) for v in system.inputs()}
    truth = {k: to_numpy(v) for k, v in system.predict(samples, use_model=args.use_model).items()}
    obs = {q: np.asarray(truth[q], dtype=float) for q in args.qois if q in truth and np.ndim(truth[q]) == 1}
    sig = {q: np.abs(obs[q]) * args.noise_std + 1e-12 for q in obs}
    rng = np.random.default_rng(0)
    obs = {q: obs[q] * (1 + args.noise_std * rng.standard_normal(obs[q].shape)) for q in obs}
    return ops, obs, sig, {}


def build_numpy_posterior(system, args, calib, names, ops, obs, sig, fields):
    """Host log-posterior (theta (W, d) -> (W,), numpy): one batched
    ``System.predict`` on the system's device per call, the likelihood in numpy;
    with M > 1, operating-condition/nuisance noise redrawn per call (from a
    ``torch.Generator`` seeded by ``default_rng(1000 + call)``) and marginalized
    by logsumexp."""
    n_ops = len(next(iter(ops.values())))
    M = max(1, args.noise_samples)
    _noise_seed = [0]

    def log_likelihood(theta: np.ndarray) -> np.ndarray:
        W = theta.shape[0]
        N = W * M * n_ops
        _noise_seed[0] += 1
        rng = np.random.default_rng(1000 + _noise_seed[0])
        batch = {}
        for v in system.inputs():
            if v.name in names:
                batch[v.name] = np.repeat(theta[:, names.index(v.name)], M * n_ops)
                continue
            base = np.tile(ops[v.name], W * M) if v.name in ops else np.full(N, _nominal(v))
            if M > 1 and v.distribution is not None and v.category in ("operating", "nuisance"):
                gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
                batch[v.name] = to_numpy(v.sample(gen, (N,), nominal=base))
            else:
                batch[v.name] = base
        qoi_list = list(obs) + list(fields)
        pred = system.predict(batch, use_model=args.use_model, qoi_ind=qoi_list, training=True)

        ll = np.zeros((W, M))
        bad = np.zeros((W, M), dtype=bool)
        for q in obs:
            p = np.asarray(to_numpy(pred[q]), dtype=float).reshape(W, M, n_ops)
            mask = np.isfinite(obs[q])
            r = (p - obs[q])[..., mask] / sig[q][mask]
            # a sample whose prediction fails (NaN) at ANY observed condition is
            # rejected: dropping the misfit would bias toward solver failures
            bad |= ~np.isfinite(r).all(axis=-1)
            w = args.id_penalty if q == "I_d" else 1.0
            ll += -0.5 * w * np.sum(np.where(np.isfinite(r), r, 0.0) ** 2, axis=-1)
        for q, specs in fields.items():
            prof, grid = field_profiles(system, pred, q)
            prof = prof.reshape(W, M, n_ops, -1)
            grid = grid.reshape(W, M, n_ops, -1)
            for k, spec in enumerate(specs):
                if spec is None:
                    continue
                g0 = grid[0, 0, k]
                pk = prof[:, :, k, :].reshape(W * M, -1)
                interp = np.stack([np.interp(spec["coords"], g0, row) for row in pk])
                r = (interp.reshape(W, M, -1) - spec["vals"]) / spec["stds"]
                bad |= ~np.isfinite(r).all(axis=-1)
                ll += -0.5 * args.field_weight * np.sum(np.where(np.isfinite(r), r, 0.0) ** 2, axis=-1)
        ll = np.where(bad | ~np.isfinite(ll), -np.inf, ll)
        # logsumexp over the M noise samples
        mx = np.max(ll, axis=1, keepdims=True)
        safe_mx = np.where(np.isfinite(mx), mx, 0.0)
        with np.errstate(divide="ignore"):  # all-M-failed walkers -> log(0) -> rejected below
            out = safe_mx[:, 0] + np.log(np.sum(np.exp(ll - safe_mx), axis=1)) - np.log(M)
        return np.where(np.isfinite(out), out, -1e30)

    def log_prior(theta: np.ndarray) -> np.ndarray:
        lp = np.zeros(theta.shape[0])
        for i, v in enumerate(calib):
            pdf = np.asarray(v.pdf(theta[:, i]), dtype=float)
            lp += np.log(np.maximum(pdf, 1e-300))
            dom = v.get_domain()
            if dom is not None:
                lp = np.where((theta[:, i] < dom[0]) | (theta[:, i] > dom[1]), -1e30, lp)
        return lp

    def log_posterior(theta: np.ndarray) -> np.ndarray:
        theta = np.atleast_2d(theta)
        lp = log_prior(theta)
        alive = lp > -1e29
        ll = np.where(alive, log_likelihood(theta), 0.0)
        return lp + ll

    return log_posterior


def build_device_posterior(system, args, calib, names, ops, obs, sig, fields, graphs: bool = True):
    """The log-posterior as ONE PyTorch function ``theta (W, d) -> (W,)`` over
    float32 tensors on the system's device: the surrogate chain
    (``System.as_torch_fn(training=True)``) once over all W * M * n_ops rows,
    the masked scalar residuals with the I_d penalty, the field terms (SVD
    reconstruction, then ``ops.interp.interp1d`` onto each condition's data
    coordinates), logsumexp over the M noise samples, the log-prior and the
    in-domain mask; anything not finite becomes -1e30. Every product runs in full
    float32 (``full_fp32``: TF32 would add per-call jitter that reads as
    log-posterior noise and collapses Metropolis acceptance).

    With M > 1 the operating/nuisance jitter is a FIXED set of common-random-
    number draws made once here, from a ``torch.Generator`` seeded 2024, so the
    posterior is deterministic; these draws are not the JAX package's
    (``jax.random`` streams are not reproducible in torch).

    On a CUDA device the function replays one CUDA graph per walker count W
    (the counterpart of JAX's ``jax.jit`` of it): ``theta`` is copied into a
    static (W, d) buffer, the graph captured on the first call with that W
    (after one warm-up call) is replayed, and its (W,) output read; a capture or
    replay error is raised. ``graphs=False`` runs it one operator at a time
    there, for comparing the two; on the CPU it always does.

    Returns ``(np_wrapper, log_posterior)``: the wrapper takes and returns numpy
    for the host samplers, with one host sync per call; ``log_posterior.eager``
    is the function without the static buffers and graphs.
    """
    dev = system.device
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    M = max(1, args.noise_samples)
    n_ops = len(next(iter(ops.values())))
    qoi_list = list(obs) + list(fields)
    fn = system.as_torch_fn(training=True, qoi_ind=qoi_list)

    # static per-(noise-sample, condition) inputs, flattened to (M * n_ops,)
    static = {}
    gen = torch.Generator().manual_seed(2024)
    for v in system.inputs():
        if v.name in names:
            continue
        if v.name in ops:
            base = np.tile(np.asarray(ops[v.name], dtype=np.float64), M)
        else:
            base = np.full(M * n_ops, _nominal(v))
        if M > 1 and v.distribution is not None and v.category in ("operating", "nuisance"):
            base = to_numpy(v.sample(gen, (M * n_ops,), nominal=base))
        static[v.name] = f32(base)

    # observations with NaN-as-mask semantics, as on the host path
    obs_t = {}
    for q in obs:
        mask = np.isfinite(obs[q])
        obs_t[q] = (f32(np.where(mask, obs[q], 0.0)), f32(mask), f32(np.where(mask, sig[q], 1.0)),
                    float(args.id_penalty if q == "I_d" else 1.0))

    # field terms: the reconstruction map and grid, and per condition (coords, vals, stds)
    field_t = {}
    for q, specs in fields.items():
        var = next(v for v in system.outputs() if v.name == q)
        if var.compression is None or var.compression.coords is None:
            raise SystemExit(f"device posterior: field term {q!r} needs a compression map")
        proj = f32(var.compression.projection)  # (grid, rank)
        grid = f32(np.asarray(var.compression.coords, dtype=float).reshape(-1))
        per_cond = [(k, f32(s["coords"]), f32(s["vals"]), f32(s["stds"]))
                    for k, s in enumerate(specs) if s is not None]
        field_t[q] = (var, proj, grid, per_cond)

    dom = np.array([v.get_domain() for v in calib], dtype=float)  # (d, 2)
    lo, hi = f32(dom[:, 0]), f32(dom[:, 1])
    weight = float(args.field_weight)

    @torch.no_grad()
    def log_posterior(theta: torch.Tensor) -> torch.Tensor:  # (W, d) -> (W,)
        with full_fp32():
            W = theta.shape[0]
            batch = {name: theta[:, i].repeat_interleave(M * n_ops) for i, name in enumerate(names)}
            for k, v in static.items():
                batch[k] = v.repeat(W)
            pred = fn(batch)

            ll = torch.zeros((W, M), dtype=torch.float32, device=dev)
            bad = torch.zeros((W, M), dtype=torch.bool, device=dev)
            for q, (vals, mask, s, w) in obs_t.items():
                p = pred[q].reshape(W, M, n_ops)
                r = (p - vals) / s * mask
                bad |= ~torch.isfinite(r).all(dim=-1)
                ll += -0.5 * w * torch.sum(torch.where(torch.isfinite(r), r, 0.0) ** 2, dim=-1)
            for q, (var, proj, grid, per_cond) in field_t.items():
                lat = pred[q].reshape(W, M, n_ops, -1)
                prof = var.denormalize(lat @ proj.T)  # (W, M, n_ops, nz)
                for k, coords, vals, stds in per_cond:
                    rows = prof[:, :, k, :].reshape(W * M, -1)
                    interp = interp1d(coords, grid[: rows.shape[-1]], rows)
                    r = (interp.reshape(W, M, -1) - vals) / stds
                    bad |= ~torch.isfinite(r).all(dim=-1)
                    ll += -0.5 * weight * torch.sum(torch.where(torch.isfinite(r), r, 0.0) ** 2, dim=-1)

            # logsumexp over the M fixed noise samples (as on the host path)
            ll = torch.where(bad | ~torch.isfinite(ll), -torch.inf, ll)
            mx = torch.max(ll, dim=1, keepdim=True).values
            safe_mx = torch.where(torch.isfinite(mx), mx, 0.0)
            lsum = safe_mx[:, 0] + torch.log(torch.sum(torch.exp(ll - safe_mx), dim=1)) - float(np.log(M))

            lp = torch.zeros(W, dtype=torch.float32, device=dev)
            for i, v in enumerate(calib):
                lp += torch.log(torch.clamp(v.pdf(theta[:, i]), min=1e-30))
            inside = torch.all((theta >= lo) & (theta <= hi), dim=-1)
            out = torch.where(inside, lp + lsum, -torch.inf)
            return torch.where(torch.isfinite(out), out, -1e30)

    programs: dict = {}  # W -> (the static theta buffer, its graph or None)

    def run(theta: torch.Tensor) -> torch.Tensor:
        """The (W,) values in the static output of W's graph (rewritten by the
        next call with W), or a new tensor where there is no graph."""
        W = theta.shape[0]
        if W not in programs:
            buf = torch.empty((W, len(names)), dtype=torch.float32, device=dev)
            buf.copy_(theta)
            graph = None
            if graphs and dev.type == "cuda":
                with full_fp32():  # the graph keeps the precision it was captured with
                    graph = cuda_graph.capture(lambda: log_posterior(buf), dev, lambda: log_posterior(buf))
            programs[W] = (buf, graph)
        buf, graph = programs[W]
        buf.copy_(theta)
        if graph is None:
            return log_posterior(buf)
        graph.replay()
        return graph.output

    def np_wrapper(theta: np.ndarray) -> np.ndarray:
        return to_numpy(run(f32(np.atleast_2d(theta)))).astype(float)

    def device_fn(theta: torch.Tensor) -> torch.Tensor:
        return run(theta).clone()

    device_fn.eager = log_posterior  # the function itself, one operator at a time on any theta
    return np_wrapper, device_fn


def _reflect_into(x: np.ndarray, dom: np.ndarray) -> np.ndarray:
    """Fold samples into [lo, hi] by reflection at the bounds: clipping would put
    every out-of-bounds walker on the same bound, a zero-spread dimension the
    stretch move can never diversify; reflection keeps the spread."""
    lo, hi = dom[:, 0], dom[:, 1]
    width = hi - lo
    y = np.mod(np.asarray(x, dtype=np.float64) - lo, 2 * width)
    y = np.where(y > width, 2 * width - y, y)
    margin = 1e-6 * width
    return lo + np.clip(y, margin, width - margin)


def main(argv=None):
    args = parser.parse_args(argv)
    system = load_system(args)
    calib = [v for v in system.inputs() if v.category == "calibration"]
    names = [v.name for v in calib]
    print(f"calibrating {len(names)} parameters: {names}")

    ops, obs, sig, fields = build_dataset(system, args)

    # a surrogate's posterior runs on the system's device; the true model's on the host
    if args.use_model is None:
        log_posterior, _ = build_device_posterior(system, args, calib, names, ops, obs, sig, fields)
        print(f"posterior: one PyTorch function over the walker ensemble on {system.device}")
    else:
        log_posterior = build_numpy_posterior(system, args, calib, names, ops, obs, sig, fields)

    x0 = np.array([_nominal(v) for v in calib])

    if args.mle:
        res = run_mle(lambda x: -float(log_posterior(x[None])[0]), x0,
                      bounds=[v.get_domain() for v in calib])
        print("MLE:", dict(zip(names, res.x)))
        x0 = res.x

    # initial proposal: a small fraction of each parameter's domain width
    widths = np.array([(v.get_domain()[1] - v.get_domain()[0]) for v in calib])
    cov0 = np.diag((0.02 * widths / np.sqrt(len(calib))) ** 2)
    dom = np.array([v.get_domain() for v in calib], dtype=float)

    if args.laplace:
        # the Laplace approximation in normalized coordinates y = (x - lo) / width
        # (raw scales span ~23 decades); stencils of 5% of each width, halved
        # near a domain edge; one batched posterior call for the whole stencil
        dom_l = dom[:, 0]
        y0 = (x0 - dom_l) / widths
        steps_y = np.minimum(0.05, 0.5 * np.minimum(y0, 1.0 - y0))
        steps_y = np.maximum(steps_y, 1e-4)
        y_map, cov_y = laplace_approximation(
            lambda y: np.asarray(log_posterior(np.atleast_2d(dom_l + y * widths))), y0, steps=steps_y)
        x_map = dom_l + y_map * widths
        cov_l = cov_y * np.outer(widths, widths)
        # flat directions (below the float32 posterior's resolution) are not
        # known to be wide: cap their standard deviation at 5% of the width
        std = np.sqrt(np.diag(cov_l))
        scale = np.minimum(1.0, 0.05 * widths / np.maximum(std, 1e-300))
        cov_l = cov_l * np.outer(scale, scale)
        print("Laplace std:", dict(zip(names, np.round(np.sqrt(np.diag(cov_l)), 6))))
        cov0 = (2.38**2 / len(calib)) * cov_l
        starts = normal_sample(x_map, cov_l, args.walkers, seed=1)
        x0 = _reflect_into(starts, dom)

    if args.sampler == "stretch":
        if np.ndim(x0) == 1:
            rng = np.random.default_rng(1)
            x0 = x0[None] + 0.02 * widths * rng.standard_normal((args.walkers, len(calib)))
        x0 = _reflect_into(x0, dom)
        if x0.shape[0] < 2 * len(calib):  # stretch needs a real ensemble
            reps = -(-2 * len(calib) // x0.shape[0])
            rng = np.random.default_rng(2)
            x0 = np.concatenate([x0] * reps)[: 2 * len(calib)]
            x0 = _reflect_into(x0 + 0.005 * widths * rng.standard_normal(x0.shape), dom)
        samples, logps, acc = stretch(log_posterior, x0, niter=args.niter,
                                      n_walkers=x0.shape[0], filename=args.file, progress=True)
    else:
        samples, logps, acc = dram(
            log_posterior, x0, niter=args.niter, n_walkers=args.walkers, cov0=cov0,
            adapt_after=max(200, args.niter // 10), adapt_interval=100,
            filename=args.file, progress=True,
        )
    print(f"acceptance: {acc:.3f}")
    flat = samples[args.niter // 4 :].reshape(-1, len(names))
    tau = integrated_autocorr_time(flat)
    print("posterior mean:", dict(zip(names, np.round(flat.mean(axis=0), 6))))
    print("posterior std: ", dict(zip(names, np.round(flat.std(axis=0), 6))))
    print("IAC:", np.round(np.atleast_1d(tau), 1), " ESS:", np.round(np.atleast_1d(ess(flat)), 0))
    print(f"chain appended to {args.file}")

    try:
        from hallthrusterpem_tpu_torch.viz import ndscatter

        ndscatter(flat[:: max(1, len(flat) // 5000)], labels=names, save_path="mcmc_corner.png")
        print("saved mcmc_corner.png")
        journal_plots(system, args, names, flat, ops, obs, sig)
        print("saved mcmc_predictive.png")
    except Exception as e:  # plotting is best-effort, as in the JAX package
        print("plots skipped:", e)
    return samples, logps, acc


def journal_plots(system, args, names, flat, ops, obs, sig, n_draws: int = 200):
    """Posterior-predictive QoIs against background pressure beside the data:
    ``n_draws`` chain rows x 12 pressures in ONE batched ``System.predict`` on
    the system's device, then the 5-95% band and median of each scalar QoI."""
    from hallthrusterpem_tpu_torch.viz import _pyplot

    plt = _pyplot()
    rng = np.random.default_rng(0)
    draws = flat[rng.integers(0, len(flat), n_draws)]
    pressures = np.geomspace(max(ops["P_b"].min() * 0.5, 1e-7), ops["P_b"].max() * 2, 12)

    qois = [q for q in obs if np.ndim(obs[q]) == 1]
    nP = len(pressures)
    batch = {}
    for v in system.inputs():
        if v.name == "P_b":
            batch[v.name] = np.tile(pressures, n_draws)
        elif v.name in ops:
            batch[v.name] = np.full(n_draws * nP, float(np.median(ops[v.name])))
        elif v.name in names:
            batch[v.name] = np.repeat(draws[:, names.index(v.name)], nP)
        else:
            batch[v.name] = np.full(n_draws * nP, _nominal(v))
    out = system.predict(batch, use_model=args.use_model, qoi_ind=qois)

    fig, axes = plt.subplots(1, len(qois), figsize=(3.2 * len(qois), 2.8), squeeze=False)
    for ax, q in zip(axes[0], qois):
        preds = np.asarray(to_numpy(out[q]), dtype=float).reshape(n_draws, nP)
        lo, mid, hi = np.nanpercentile(preds, [5, 50, 95], axis=0)
        ax.fill_between(pressures, lo, hi, alpha=0.3, color="0.5")
        ax.plot(pressures, mid, "-k", lw=1)
        mask = np.isfinite(obs[q])
        ax.errorbar(ops["P_b"][mask], obs[q][mask], yerr=2 * sig[q][mask], fmt="o", ms=4,
                    color="r", label="data")
        ax.set_xscale("log")
        ax.set_xlabel("background pressure (Torr)")
        ax.set_ylabel(q)
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig("mcmc_predictive.png", dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    main()
