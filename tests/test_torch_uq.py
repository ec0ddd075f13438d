"""Port against the JAX package: the UQ modules (``uq/mcmc.py``, ``uq/sobol.py``,
``uq/montecarlo.py``, ``uq/utils.py``).

The samplers draw from ``np.random.default_rng(seed)`` in both packages, so on
the same deterministic float64 ``logpdf`` (a correlated Gaussian, a Rosenbrock)
the chains, log-pdfs and acceptance rates are held EQUAL, bit for bit. The
port's chains persist as ``.npz`` and are held equal to the arrays JAX's
``.h5`` holds, a continuation included. Sobol' indices, the diagnostics and the
helpers take the same numpy inputs and are held equal. Monte Carlo on the fake
PEM: the port's ``run_mc`` draws its own samples (``torch.Generator``), JAX's
``System.predict`` takes the same samples; outputs within 1e-6 of their scale
(the fake models compute in float32 on both sides: a few ulp), percentile
tables and rel-L2 tables equal.
"""

import json
import warnings

import h5py
import numpy as np
import pytest
import torch

from hallthrusterpem_tpu import uq as juq
from hallthrusterpem_tpu.core import yaml_loader as jyaml
from hallthrusterpem_tpu.uq import mcmc as jmcmc
from hallthrusterpem_tpu.uq import montecarlo as jmc
from hallthrusterpem_tpu_torch import uq as tuq
from hallthrusterpem_tpu_torch.core.json_loader import load_system
from hallthrusterpem_tpu_torch.uq import mcmc as tmcmc
from hallthrusterpem_tpu_torch.uq import montecarlo as tmc
from test_torch_system import ROOT, yaml_as_json_doc

torch.set_num_threads(2)
MEAN = np.array([1.0, -2.0, 0.5])
COV = np.array([[1.0, 0.6, 0.0], [0.6, 2.0, -0.3], [0.0, -0.3, 0.5]])
ICOV = np.linalg.inv(COV)


def gauss(x):
    d = np.atleast_2d(x) - MEAN
    return -0.5 * np.einsum("wi,ij,wj->w", d, ICOV, d)


def rosenbrock(x):
    x = np.atleast_2d(x)
    return -(np.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1 - x[:, :-1]) ** 2, axis=-1)) / 20.0


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


DRAM_CASES = {
    "delayed-adaptive-walkers": dict(x0=np.zeros(3), n_walkers=6, adapt_after=40, adapt_interval=20),
    "no-delay": dict(x0=np.zeros(3), n_walkers=4, delayed=False, adapt_after=40, adapt_interval=20),
    "no-adapt": dict(x0=np.zeros(3), n_walkers=4, adaptive=False),
    "single-chain-squeezed": dict(x0=np.zeros(3), adapt_after=50, adapt_interval=25),
    "ensemble-start-cov0": dict(x0=np.random.default_rng(3).standard_normal((5, 3)),
                                cov0=0.3 * np.eye(3), adapt_after=30, adapt_interval=10),
    "rosenbrock": dict(x0=np.array([-1.0, 1.0, 0.5]), n_walkers=4, logpdf=rosenbrock, adapt_after=50,
                       adapt_interval=25),
}


@pytest.mark.parametrize("case", list(DRAM_CASES))
def test_dram_matches_jax(case):
    kw = dict(DRAM_CASES[case])
    logpdf = kw.pop("logpdf", gauss)
    ref = juq.dram(logpdf, niter=200, seed=4, **kw)
    got = tuq.dram(logpdf, niter=200, seed=4, **kw)
    _equal(got[0], ref[0])
    _equal(got[1], ref[1])
    assert got[2] == ref[2]
    if case == "single-chain-squeezed":
        assert got[0].shape == (201, 3) and got[1].shape == (201,)


STRETCH_CASES = {
    "center-jitter": dict(x0=MEAN + 0.1, n_walkers=8),
    "center-scale": dict(x0=MEAN, n_walkers=10, scale=np.array([0.1, 0.2, 0.05])),
    "ensemble": dict(x0=np.random.default_rng(5).standard_normal((8, 3))),
    "rosenbrock": dict(x0=np.random.default_rng(6).uniform(-1, 1, (12, 3)), logpdf=rosenbrock),
}


@pytest.mark.parametrize("case", list(STRETCH_CASES))
def test_stretch_matches_jax(case):
    kw = dict(STRETCH_CASES[case])
    logpdf = kw.pop("logpdf", gauss)
    ref = juq.stretch(logpdf, niter=150, seed=7, **kw)
    got = tuq.stretch(logpdf, niter=150, seed=7, **kw)
    _equal(got[0], ref[0])
    _equal(got[1], ref[1])
    assert got[2] == ref[2]


def test_stretch_frozen_dimension_matches_jax():
    """The re-jitter of a zero-spread dimension: both warn and draw the jitter
    from the same stream (the chains stay equal)."""
    x0 = np.random.default_rng(0).standard_normal((8, 3))
    x0[:, 1] = 5.0
    out = []
    for pkg in (juq, tuq):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out.append(pkg.stretch(gauss, x0.copy(), niter=100, n_walkers=8, seed=1))
        assert any("zero-spread" in str(w.message) for w in rec)
    _equal(out[1][0], out[0][0])
    _equal(out[1][1], out[0][1])


def test_batched_fallback_matches_jax():
    """A logpdf that returns one number for any input is called per walker in
    both packages; a tensor result is read as numpy."""
    scalar = lambda x: float(gauss(x).sum())
    x = np.random.default_rng(1).standard_normal((4, 3))
    _equal(tmcmc._batched(scalar, x), jmcmc._batched(scalar, x))
    _equal(tmcmc._batched(lambda x: torch.as_tensor(gauss(x)), x), jmcmc._batched(gauss, x))


def _h5_arrays(path):
    with h5py.File(path, "r") as f:
        return np.asarray(f["samples"]), np.asarray(f["log_pdf"])


def _npz_arrays(path):
    with np.load(path) as f:
        return f["samples"], f["log_pdf"]


@pytest.mark.parametrize("sampler", ["dram", "stretch"])
def test_npz_chain_matches_h5(tmp_path, sampler):
    """Two runs appended to one file, the second started from the file's last
    ensemble (stretch skips that first row): the port's ``.npz`` arrays equal
    JAX's ``.h5`` datasets, and ``read_mcmc_chain`` reads them back equal."""
    h5, npz = tmp_path / "chain.h5", tmp_path / "chain.npz"
    x0 = np.random.default_rng(2).standard_normal((8, 3))
    for pkg, path in ((juq, h5), (tuq, npz)):
        start = x0
        for seed in (0, 1):
            if sampler == "dram":
                s, _, _ = pkg.dram(gauss, start, niter=30, seed=seed, filename=str(path))
            else:
                s, _, _ = pkg.stretch(gauss, start, niter=30, seed=seed, filename=str(path))
            start = s[-1]
    ref, got = _h5_arrays(h5), _npz_arrays(npz)
    n = 62 if sampler == "dram" else 61
    assert got[0].shape == (n, 8, 3) and got[1].shape == (n, 8)
    _equal(got[0], ref[0])
    _equal(got[1], ref[1])
    for kw in (dict(burn_frac=0.0, clean=False), dict(burn_frac=0.2)):
        r, g = jmcmc.read_mcmc_chain(h5, **kw), tmcmc.read_mcmc_chain(npz, **kw)
        _equal(g[0], r[0])
        _equal(g[1], r[1])


def test_read_mcmc_chain_drops_nonfinite_rows(tmp_path):
    rng = np.random.default_rng(3)
    samples, logps = rng.standard_normal((40, 4, 2)), rng.standard_normal((40, 4))
    logps[[5, 17, 30], [0, 2, 3]] = [-np.inf, np.nan, np.inf]
    jmcmc._append_h5(tmp_path / "c.h5", samples, logps)
    tmcmc._append_npz(tmp_path / "c.npz", samples, logps)
    for kw in (dict(), dict(burn_frac=0.3), dict(clean=False)):
        r = jmcmc.read_mcmc_chain(tmp_path / "c.h5", **kw)
        g = tmcmc.read_mcmc_chain(tmp_path / "c.npz", **kw)
        _equal(g[0], r[0])
        _equal(g[1], r[1])
    # a row goes when its smallest log-pdf is not finite: -inf and NaN do, +inf does not
    assert tmcmc.read_mcmc_chain(tmp_path / "c.npz", burn_frac=0.0)[0].shape[0] == 38


@pytest.mark.parametrize("shape", [(3000,), (2500, 3)])
def test_diagnostics_match_jax(shape):
    rng = np.random.default_rng(4)
    x = np.cumsum(rng.standard_normal(shape), axis=0) * 0.05 + rng.standard_normal(shape)
    _equal(tuq.autocorrelation(x), juq.autocorrelation(x))
    _equal(tuq.autocorrelation(x, maxlag=50), juq.autocorrelation(x, maxlag=50))
    _equal(tuq.integrated_autocorr_time(x), juq.integrated_autocorr_time(x))
    _equal(tuq.ess(x), juq.ess(x))


def _ishigami(x, a=7.0, b=0.1):
    return np.sin(x[:, 0]) + a * np.sin(x[:, 1]) ** 2 + b * x[:, 2] ** 4 * np.sin(x[:, 0])


def _box_sampler(n, seed):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (n, 3))


SOBOL_CASES = {
    "vector": lambda x: _ishigami(x),
    "matrix-with-nan": lambda x: np.stack([_ishigami(x), np.where(x[:, 0] > 3.0, np.nan, x[:, 1] ** 2)], -1),
    "dict": lambda x: {"f": _ishigami(x), "g": x[:, 2] * x[:, 0]},
}


@pytest.mark.parametrize("case", list(SOBOL_CASES))
def test_sobol_matches_jax(case):
    """Ishigami and friends through both packages' ``sobol_sa`` with the same
    sampler; the port also takes a function returning tensors."""
    fn = SOBOL_CASES[case]
    ref = juq.sobol_sa(fn, _box_sampler, 2000, 3, seed=3)
    as_tensor = (lambda x: {k: torch.as_tensor(v) for k, v in fn(x).items()}) if case == "dict" \
        else (lambda x: torch.as_tensor(fn(x)))
    for f in (fn, as_tensor):
        got = tuq.sobol_sa(f, _box_sampler, 2000, 3, seed=3)
        assert got["qois"] == ref["qois"]
        for k in ("S1", "ST", "variance", "mean"):
            _equal(got[k], ref[k])
    if case == "vector":  # the analytic Ishigami indices, as a sanity check
        assert np.allclose(got["S1"][:, 0], [0.314, 0.442, 0.0], atol=0.08)


def test_utils_match_jax():
    """Hessian (one batched call, also through a tensor-returning function),
    positive-definite repair, normal sampling, Laplace, MLE."""
    x0 = np.array([0.3, -0.2, 0.1])
    _equal(tuq.approx_hess(gauss, x0), juq.approx_hess(gauss, x0))
    steps = np.array([0.05, 0.1, 0.02])
    _equal(tuq.approx_hess(lambda x: torch.as_tensor(rosenbrock(x)), x0, steps=steps),
           juq.approx_hess(rosenbrock, x0, steps=steps))
    M = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.5], [0.0, 0.5, -1.0]])
    assert not tuq.is_positive_definite(M) and not juq.is_positive_definite(M)
    _equal(tuq.nearest_positive_definite(M), juq.nearest_positive_definite(M))
    v = np.array([[1.0, 2.0, 3.0]])
    _equal(tuq.normal_sample(MEAN, v.T @ v, 50, seed=2), juq.normal_sample(MEAN, v.T @ v, 50, seed=2))
    _equal(tuq.normal_sample(MEAN, COV, 50, seed=1), juq.normal_sample(MEAN, COV, 50, seed=1))
    for a, b in zip(tuq.laplace_approximation(gauss, MEAN), juq.laplace_approximation(gauss, MEAN)):
        _equal(a, b)
    with pytest.raises(ValueError):
        tuq.laplace_approximation(lambda x: -gauss(x), MEAN)
    neg = lambda x: -float(gauss(x)[0])
    bounds = [(-3, 3), (-4, 2), (-1, 2)]
    r, g = juq.run_mle(neg, np.zeros(3), bounds=bounds), tuq.run_mle(neg, np.zeros(3), bounds=bounds)
    _equal(g.x, r.x)
    neg_v = lambda x: -gauss(np.asarray(x).T)  # scipy's vectorized layout: (d, S)
    de = dict(method="differential_evolution", seed=0, maxiter=20, updating="deferred")
    r = juq.run_mle(neg_v, None, bounds=bounds, **de)
    g = tuq.run_mle(neg_v, None, bounds=bounds, **de)
    _equal(g.x, r.x)
    with pytest.raises(ValueError):
        tuq.run_mle(neg_v, None, method="differential_evolution")


def test_mc_matches_jax_on_fake_pem(tmp_path):
    """``run_mc`` on the fake PEM (true models): JAX's ``System.predict`` on the
    port's samples gives the same outputs; ``mc_percentiles`` and
    ``l2_error_table`` equal on the same arrays."""
    path = tmp_path / "fake_pem.json"
    path.write_text(json.dumps(yaml_as_json_doc(ROOT / "tests" / "fake_pem.yml")))
    tsys = load_system(path, device="cpu")
    jsys = jyaml.load_system(ROOT / "tests" / "fake_pem.yml")
    samples, out = tuq.run_mc(tsys, 64, use_model="best", constants=["operating"], seed=3,
                              qois=["V_cc", "T", "I_d", "u_ion"])
    again, _ = tuq.run_mc(tsys, 64, use_model="best", constants=["operating"],
                          generator=torch.Generator().manual_seed(3), qois=["T"])
    assert all(torch.equal(again[k], samples[k]) for k in samples)
    assert set(out) == {"V_cc", "T", "I_d", "u_ion", "u_ion_coords"}
    x = {k: v.numpy().astype(np.float64) for k, v in samples.items()}
    ref = jsys.predict(x, use_model="best", qoi_ind=["V_cc", "T", "I_d", "u_ion"])
    for k in ("V_cc", "T", "I_d", "u_ion"):
        got, want = out[k].numpy(), np.asarray(ref[k])
        assert got.shape == want.shape and np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want)), k
    arrays = {k: np.asarray(ref[k], dtype=np.float64) for k in ("T", "I_d", "u_ion")}
    arrays["T"][[3, 9]] = np.nan
    tp, jp = tuq.mc_percentiles(arrays), juq.mc_percentiles(arrays)
    tp_t = tuq.mc_percentiles({k: torch.as_tensor(v) for k, v in arrays.items()}, percentiles=(10, 50))
    for k in arrays:
        for p in (5, 50, 95):
            _equal(tp[k][p], jp[k][p])
        _equal(tp_t[k][50], jp[k][50])
    noisy = {k: v * (1 + 0.01 * np.sin(np.arange(v.size)).reshape(v.shape)) for k, v in arrays.items()}
    noisy["V_cc"] = np.ones(5)
    truth = dict(arrays, V_cc=np.ones(4))
    got = tmc.l2_error_table({k: torch.as_tensor(v) for k, v in noisy.items()}, truth)
    assert got == jmc.l2_error_table(noisy, truth) and set(got) == {"T", "I_d", "u_ion"}
