"""MCMC samplers over a batched log-density, with chains kept in ``.npz`` files
(the JAX package's ``uq/mcmc.py``).

:func:`dram` (delayed-rejection adaptive Metropolis) and :func:`stretch` (the
affine-invariant ensemble move) run ``W`` walkers as one ensemble: each proposal
of the whole ensemble is ONE call of ``logpdf`` on a ``(W, d)`` batch, which may
evaluate on the card (the pem_v0 device posterior does); the samplers'
bookkeeping is numpy on the host. Both draw from ``np.random.default_rng(seed)``
in the JAX package's order, so on the same deterministic ``logpdf`` they give
the same chains draw for draw.

Chains persist as ``.npz`` with arrays ``samples`` (n, W, d) and ``log_pdf``
(n, W); a later run on the same file appends along the first axis.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from hallthrusterpem_tpu_torch.core.dataset import to_numpy

__all__ = ["dram", "stretch", "read_mcmc_chain", "autocorrelation",
           "integrated_autocorr_time", "ess"]


def _batched(logpdf: Callable, x: np.ndarray) -> np.ndarray:
    """Evaluate logpdf on (W, d) -> (W,); a ``logpdf`` that returns one value
    for a batch is called once per walker instead."""
    out = to_numpy(logpdf(x))
    if out.shape == x.shape[:1]:
        return out
    if out.ndim == 0 and x.shape[0] == 1:
        return out[None]
    return np.asarray([float(to_numpy(logpdf(xi))) for xi in x])


def dram(
    logpdf: Callable,
    x0,
    niter: int = 10000,
    cov0=None,
    n_walkers: Optional[int] = None,
    gamma: float = 0.1,
    eps: float = 1e-12,
    adapt_after: int = 1000,
    adapt_interval: int = 100,
    delayed: bool = True,
    adaptive: bool = True,
    filename: Optional[str] = None,
    seed: int = 0,
    progress: bool = False,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Run DRAM chains.

    :param logpdf: log target density, called with (W, d) batches; may return a
        numpy array or a tensor
    :param x0: (d,) start point or (W, d) ensemble of starts
    :param cov0: initial proposal covariance (d, d); defaults to (0.05 * scale)^2 I
    :param gamma: second-stage proposal shrink factor (delayed rejection)
    :param eps: adaptation regularization
    :param filename: optional ``.npz`` file the chains are appended to
    :returns: (samples (niter+1, W, d), squeezed over W for a 1-D ``x0`` and no
        ``n_walkers``; log-pdf values; acceptance rate)
    """
    rng = np.random.default_rng(seed)
    x0 = np.atleast_2d(np.asarray(x0, dtype=np.float64))
    squeeze = n_walkers is None and x0.shape[0] == 1
    if n_walkers is not None and x0.shape[0] == 1:
        x0 = np.repeat(x0, n_walkers, axis=0)
        x0 = x0 + 1e-6 * np.abs(x0) * rng.standard_normal(x0.shape)
    W, d = x0.shape

    if cov0 is None:
        scale = np.maximum(np.abs(x0).mean(axis=0), 1.0) * 0.05
        cov0 = np.diag(scale**2)
    cov = np.broadcast_to(np.asarray(cov0, dtype=np.float64), (W, d, d)).copy()
    sd = 2.38**2 / d

    samples = np.empty((niter + 1, W, d))
    logps = np.empty((niter + 1, W))
    samples[0] = x0
    logps[0] = _batched(logpdf, x0)

    # recursive mean/cov accumulators (per walker)
    run_mean = x0.copy()
    run_cov = np.zeros((W, d, d))
    n_acc = 0

    chol = np.linalg.cholesky(cov + eps * np.eye(d))

    for t in range(1, niter + 1):
        x = samples[t - 1]
        lp_x = logps[t - 1]

        z = rng.standard_normal((W, d))
        y1 = x + np.einsum("wij,wj->wi", chol, z)
        lp_y1 = _batched(logpdf, y1)
        log_a1 = lp_y1 - lp_x
        u = np.log(rng.uniform(size=W))
        acc1 = u < log_a1

        x_new = np.where(acc1[:, None], y1, x)
        lp_new = np.where(acc1, lp_y1, lp_x)

        if delayed:
            rej = ~acc1
            if rej.any():  # the second-stage draws only when some walker rejected
                z2 = rng.standard_normal((W, d))
                y2 = x + np.sqrt(gamma) * np.einsum("wij,wj->wi", chol, z2)
                lp_y2 = np.where(rej, _batched(logpdf, y2), -np.inf)
                # DR acceptance (Mira 2001): alpha2 = min(1, pi(y2) q(y2,y1) (1-a1(y2,y1))
                #                                        / [pi(x) q(x,y1) (1-a1(x,y1))])
                with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
                    lq_num = _gauss_logpdf(y1, y2, chol)
                    lq_den = _gauss_logpdf(y1, x, chol)
                    a1_y2y1 = np.minimum(1.0, np.exp(lp_y1 - lp_y2))
                    a1_xy1 = np.minimum(1.0, np.exp(lp_y1 - lp_x))
                    log_a2 = (
                        lp_y2 - lp_x + lq_num - lq_den
                        + np.log(np.maximum(1 - a1_y2y1, 1e-300))
                        - np.log(np.maximum(1 - a1_xy1, 1e-300))
                    )
                acc2 = rej & (np.log(rng.uniform(size=W)) < log_a2) & np.isfinite(lp_y2)
                x_new = np.where(acc2[:, None], y2, x_new)
                lp_new = np.where(acc2, lp_y2, lp_new)
                n_acc += int(acc2.sum())

        n_acc += int(acc1.sum())
        samples[t] = x_new
        logps[t] = lp_new

        # recursive adaptation state
        delta = x_new - run_mean
        run_mean += delta / (t + 1)
        run_cov += np.einsum("wi,wj->wij", delta, x_new - run_mean)

        if adaptive and t >= adapt_after and t % adapt_interval == 0:
            cov = sd * (run_cov / t) + sd * eps * np.eye(d)
            try:
                chol = np.linalg.cholesky(cov)
            except np.linalg.LinAlgError:
                from hallthrusterpem_tpu_torch.uq.utils import nearest_positive_definite

                cov = np.stack([nearest_positive_definite(c) for c in cov])
                chol = np.linalg.cholesky(cov)

        if progress and t % max(1, niter // 20) == 0:
            print(f"dram: {t}/{niter} acc={n_acc / (t * W):.3f}")

    acceptance = n_acc / (niter * W)

    if filename is not None:
        _append_npz(filename, samples, logps)

    if squeeze:
        return samples[:, 0, :], logps[:, 0], acceptance
    return samples, logps, acceptance


def stretch(
    logpdf: Callable,
    x0,
    niter: int = 10000,
    n_walkers: int = 64,
    a: float = 2.0,
    scale=None,
    filename: Optional[str] = None,
    seed: int = 0,
    progress: bool = False,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Affine-invariant stretch-move ensemble sampler (Goodman & Weare 2010, the
    emcee move); each half-ensemble update is one batched ``logpdf`` call.

    It needs no proposal scale, which suits posteriors whose parameters span
    many decades (c4 ~1e20 beside l_t ~1e-3 in pem_v0).

    :param x0: (d,) center or (W, d) ensemble of starts; a (d,) center is
        jittered by ``scale`` (default 1e-3 of |x0|, elementwise) per walker
    :param a: stretch parameter (2.0 is the standard choice)
    :param filename: optional ``.npz`` file the chains are appended to; on a
        file that already holds chains the first row (the ensemble the run
        started from, the file's last) is not written again
    :returns: (samples (niter+1, W, d), log-pdf values, acceptance rate)
    """
    rng = np.random.default_rng(seed)
    x0 = np.atleast_2d(np.asarray(x0, dtype=np.float64))
    if x0.shape[0] == 1:
        jitter = np.asarray(scale, dtype=np.float64) if scale is not None \
            else 1e-3 * np.maximum(np.abs(x0[0]), 1e-12)
        x0 = x0 + jitter * rng.standard_normal((n_walkers, x0.shape[1]))
    W, d = x0.shape
    if W < 2 * d:
        raise ValueError(f"stretch sampler needs >= 2*d walkers (have {W}, d={d})")
    # The move proposes within the affine span of the ensemble: a dimension whose
    # initial spread is (near) zero can never diversify. Re-jitter it at 1e-3 of
    # its ensemble-center scale.
    spread = x0.std(axis=0)
    ref = np.maximum(np.abs(x0).max(axis=0), 1e-12)
    frozen = spread < 1e-9 * ref
    if frozen.any():
        warnings.warn(f"stretch: re-jittering {int(frozen.sum())} zero-spread "
                      "ensemble dimension(s); a frozen dimension cannot mix",
                      stacklevel=2)
        jit = 1e-3 * ref[frozen]
        x0[:, frozen] = x0[:, frozen] + jit * rng.standard_normal((W, int(frozen.sum())))
    half = W // 2

    samples = np.empty((niter + 1, W, d))
    logps = np.empty((niter + 1, W))
    samples[0] = x0
    logps[0] = _batched(logpdf, x0)
    n_acc = 0

    for t in range(1, niter + 1):
        x = samples[t - 1].copy()
        lp = logps[t - 1].copy()
        for s0, s1 in ((slice(0, half), slice(half, W)), (slice(half, W), slice(0, half))):
            mov, com = x[s0], x[s1]
            nm = mov.shape[0]
            # z ~ g(z) prop 1/sqrt(z) on [1/a, a]
            z = (1.0 + (a - 1.0) * rng.uniform(size=nm)) ** 2 / a
            partners = com[rng.integers(0, com.shape[0], size=nm)]
            prop = partners + z[:, None] * (mov - partners)
            lp_prop = _batched(logpdf, prop)
            log_acc = (d - 1) * np.log(z) + lp_prop - lp[s0]
            acc = np.log(rng.uniform(size=nm)) < log_acc
            x[s0] = np.where(acc[:, None], prop, mov)
            lp[s0] = np.where(acc, lp_prop, lp[s0])
            n_acc += int(acc.sum())
        samples[t] = x
        logps[t] = lp
        if progress and t % max(1, niter // 20) == 0:
            print(f"stretch: {t}/{niter} acc={n_acc / (t * W):.3f}")

    acceptance = n_acc / (niter * W)
    if filename is not None:
        skip_first = False
        if Path(filename).exists():
            with np.load(filename) as f:
                skip_first = "samples" in f.files and f["samples"].shape[0] > 0
        _append_npz(filename, samples[1:] if skip_first else samples,
                    logps[1:] if skip_first else logps)
    return samples, logps, acceptance


def _gauss_logpdf(x, mean, chol):
    """Log N(x; mean, L L^T) up to the shared constant, batched over walkers."""
    diff = x - mean
    sol = np.linalg.solve(chol, diff[..., None])[..., 0]
    return -0.5 * np.sum(sol**2, axis=-1)


def _append_npz(filename, samples, logps):
    """Append chains to ``filename`` (``samples``, ``log_pdf``), creating it; the
    file is rewritten whole and replaced in one rename."""
    path = Path(filename)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        with np.load(path) as f:
            old = {k: f[k] for k in f.files}
        if "samples" in old:
            samples = np.concatenate([old["samples"], samples])
            logps = np.concatenate([old["log_pdf"], logps])
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fd:
        np.savez(fd, samples=samples, log_pdf=logps)
    os.replace(tmp, path)


def read_mcmc_chain(filename, burn_frac: float = 0.1, clean: bool = True):
    """Load chains from a ``.npz`` file; with ``clean``, drop the first
    ``burn_frac`` of the rows, then every row with a non-finite log-pdf."""
    with np.load(filename) as f:
        samples = np.asarray(f["samples"])
        logps = np.asarray(f["log_pdf"])
    if clean:
        burn = int(burn_frac * samples.shape[0])
        samples, logps = samples[burn:], logps[burn:]
        good = np.isfinite(logps if logps.ndim == 1 else logps.min(axis=-1))
        samples, logps = samples[good], logps[good]
    return samples, logps


# ---------------------------------------------------------------------- diagnostics
def autocorrelation(chain: np.ndarray, maxlag: Optional[int] = None) -> np.ndarray:
    """Normalized autocorrelation function per dimension (FFT-based);
    ``chain``: (n, d) or (n,)."""
    x = np.atleast_2d(np.asarray(chain, dtype=np.float64).T).T  # (n, d)
    n = x.shape[0]
    maxlag = maxlag or n // 2
    x = x - x.mean(axis=0)
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, n=m, axis=0)
    acf = np.fft.irfft(f * np.conj(f), n=m, axis=0)[:maxlag].real
    acf /= np.maximum(acf[0], 1e-300)
    return acf.squeeze()


def integrated_autocorr_time(chain: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation time with Sokal's adaptive window."""
    acf = np.atleast_2d(autocorrelation(chain).T).T
    taus = 2.0 * np.cumsum(acf, axis=0) - 1.0
    out = []
    for j in range(taus.shape[1]):
        window = np.arange(len(taus)) >= c * taus[:, j]
        idx = np.argmax(window) if window.any() else len(taus) - 1
        out.append(taus[idx, j])
    return np.asarray(out).squeeze()


def ess(chain: np.ndarray) -> np.ndarray:
    """Effective sample size per dimension."""
    n = np.asarray(chain).shape[0]
    return n / np.maximum(integrated_autocorr_time(chain), 1.0)
