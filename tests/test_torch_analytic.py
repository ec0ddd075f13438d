"""Port against the JAX package: cathode, plume, special functions, quadrature,
interpolation and the anomalous-transport profile, on the same numpy inputs.
Tolerance rtol 1e-5: both evaluate the same float32 expressions; the sums
(Simpson contraction, Horner chains) may round in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hallthrusterpem_tpu.models.cathode import cathode_coupling as jax_cathode
from hallthrusterpem_tpu.models.plume import current_density as jax_current_density
from hallthrusterpem_tpu.models.thruster import config as jcfg
from hallthrusterpem_tpu.models.thruster import solver as jsolver
from hallthrusterpem_tpu.ops import integrate as jint
from hallthrusterpem_tpu.ops import interp as jinterp
from hallthrusterpem_tpu.ops import special as jspecial
from hallthrusterpem_tpu_torch.models.cathode import cathode_coupling
from hallthrusterpem_tpu_torch.models.plume import current_density
from hallthrusterpem_tpu_torch.models.thruster import config as tcfg
from hallthrusterpem_tpu_torch.models.thruster import solver as tsolver
from hallthrusterpem_tpu_torch.ops import integrate, interp, special

RTOL = 1e-5
t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))


def _plume_inputs(rng, n):
    return {
        "P_b": 10 ** (rng.uniform(0, 4, n) - 8), "c0": rng.uniform(0.1, 0.9, n),
        "c1": rng.uniform(0.1, 0.9, n), "c2": rng.uniform(-15, 15, n),
        "c3": rng.uniform(0.1, 1.1, n), "c4": 10 ** rng.uniform(18, 22, n),
        "c5": 10 ** rng.uniform(14, 18, n), "sigma_cex": rng.uniform(51e-20, 58e-20, n),
        "I_B0": rng.uniform(2, 8, n), "T": rng.uniform(0.05, 0.1, n),
    }


def test_cathode_coupling_matches():
    rng = np.random.default_rng(0)
    n = 200
    x = {"P_b": 10 ** rng.uniform(-8, -4, n), "V_a": rng.uniform(200, 400, n),
         "T_e": rng.uniform(1, 5, n), "V_vac": rng.uniform(0, 60, n),
         "Pstar": rng.uniform(10e-6, 100e-6, n), "P_T": rng.uniform(10e-6, 100e-6, n)}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    ref = np.asarray(jax_cathode(x)["V_cc"])
    got = cathode_coupling({k: t(v) for k, v in x.items()})["V_cc"].numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-5)


def test_current_density_matches():
    rng = np.random.default_rng(1)
    x = {k: v.astype(np.float32) for k, v in _plume_inputs(rng, 100).items()}
    ref = {k: np.asarray(v) for k, v in jax_current_density(x, sweep_radius=1.0).items()}
    got = {k: v.numpy() for k, v in current_density({k: t(v) for k, v in x.items()}).items()}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=1e-30, equal_nan=True, err_msg=k)


def test_pressure_sweep_current_conservation():
    """Integrated beam current is invariant across the pressure sweep
    (the invariant of tests/test_plume.py, rel. err < 1e-4)."""
    n = 100
    P = t(10 ** np.linspace(-6, -4, n))
    full = lambda v: torch.full((n,), v, dtype=torch.float32)
    x = {"P_b": P, "c0": full(0.1), "c1": full(0.7), "c2": full(-8.0), "c3": full(0.2),
         "c4": full(1e20), "c5": full(1e16), "sigma_cex": full(55e-20), "I_B0": full(3.0)}
    j = current_density(x)["j_ion"].double().numpy()
    theta = np.linspace(0, np.pi / 2, 91)
    current = 2 * np.pi * (j * np.sin(theta)) @ integrate.simpson_weights(theta)
    err = np.sqrt(np.sum((current - current.mean()) ** 2) / np.sum(current**2))
    assert err < 1e-4


def test_special_functions_match():
    rng = np.random.default_rng(2)
    x = rng.uniform(-6, 6, 300).astype(np.float32)
    y = rng.uniform(0, 6, 300).astype(np.float32)
    wr_j, wi_j = (np.asarray(v) for v in jspecial.wofz_parts(x, y))
    wr_t, wi_t = (v.numpy() for v in special.wofz_parts(t(x), t(y)))
    np.testing.assert_allclose(wr_t, wr_j, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(wi_t, wi_j, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(special.dawson(t(x)).numpy(), np.asarray(jspecial.dawson(x)),
                               rtol=RTOL, atol=1e-6)
    xs = x / 3
    np.testing.assert_allclose(special.erfi(t(xs)).numpy(), np.asarray(jspecial.erfi(xs)),
                               rtol=RTOL, atol=1e-6)
    a, b = np.abs(x) / 2, y
    np.testing.assert_allclose(special.exp_neg_sq_erfi(t(a)).numpy(),
                               np.asarray(jspecial.exp_neg_sq_erfi(a)), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(special.exp_neg_asq_re_erfi(t(a), t(b)).numpy(),
                               np.asarray(jspecial.exp_neg_asq_re_erfi(a, b)), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("n", [2, 7, 91, 100])
def test_simpson_weights_match(n):
    x = np.sort(np.random.default_rng(n).uniform(0, 2, n))
    np.testing.assert_array_equal(integrate.simpson_weights(x), jint.simpson_weights(x))


@pytest.mark.parametrize("n,axis", [(7, -1), (91, -1), (100, 0)])
def test_simpson_and_trapz_weights_match(n, axis):
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(0, 2, n))
    np.testing.assert_array_equal(integrate.trapz_weights(x), jint.trapz_weights(x))
    y = rng.normal(size=(3, n) if axis == -1 else (n, 3)).astype(np.float32)
    ref = np.asarray(jint.simpson(y, x=x, axis=axis))
    got = integrate.simpson(t(y), x=x, axis=axis)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-6)
    w = jint.simpson_weights(x)
    np.testing.assert_allclose(integrate.simpson(t(y), weights=w, axis=axis).numpy(),
                               np.asarray(jint.simpson(y, weights=w, axis=axis)), rtol=RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="provide x or weights"):
        integrate.simpson(t(y))


def test_wofz_matches():
    rng = np.random.default_rng(4)
    z = (rng.uniform(-6, 6, 200) + 1j * rng.uniform(0, 6, 200)).astype(np.complex64)
    got = special.wofz(torch.as_tensor(z))
    assert got.is_complex()
    np.testing.assert_allclose(got.numpy(), np.asarray(jspecial.wofz(z)), rtol=RTOL, atol=1e-6)
    x = rng.uniform(-6, 6, 50).astype(np.float32)
    np.testing.assert_allclose(special.wofz(t(x)).numpy(), np.asarray(jspecial.wofz(x)), rtol=RTOL, atol=1e-6)


def test_interp1d_matches():
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0, 1, 40)).astype(np.float32)
    fp = rng.normal(size=(3, 40)).astype(np.float32)
    xq = rng.uniform(-0.1, 1.1, 70).astype(np.float32)
    ref = np.asarray(jinterp.interp1d(xq, xp, fp))
    np.testing.assert_allclose(interp.interp1d(t(xq), t(xp), t(fp)).numpy(), ref, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("anom_model,shift", [("TwoZoneBohm", "LogisticPressureShift"),
                                              ("TwoZoneBohm", "none"),
                                              ("GaussianBohm", "SimpleLogisticShift")])
def test_anomalous_profile_matches(anom_model, shift):
    rng = np.random.default_rng(4)
    B = 5
    over = {"P_b": rng.uniform(0, 5e-5, B), "l_t": rng.uniform(1e-3, 4e-3, B),
            "a1": rng.uniform(4e-3, 8e-3, B), "a2": rng.uniform(0.04, 0.3, B),
            "shift_dz": rng.uniform(0.1, 0.3, B), "anom_width": np.where(rng.uniform(size=B) > 0.5, 2e-3, 0.0)}
    over = {k: v.astype(np.float32) for k, v in over.items()}
    kw = dict(num_cells=60, anom_model=anom_model, pressure_shift=shift)
    cj, ct = jcfg.SolverConfig(**kw), tcfg.SolverConfig(**kw)
    pj = jcfg.make_params(over)
    z = np.asarray(cj.cell_centers(), np.float32)
    ref = np.asarray(jax.vmap(lambda p: jsolver.anomalous_profile(p, jnp.asarray(z), cj))(pj))
    pt = tcfg.make_params({k: t(v) for k, v in over.items()}, device="cpu")
    got = tsolver.anomalous_profile(pt, t(z), ct).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("wall", ["sheath", "landmark"])
def test_wall_energy_loss_rate_matches(wall):
    rng = np.random.default_rng(5)
    Te = rng.uniform(0.5, 120, (4, 30)).astype(np.float32)
    ne = rng.uniform(1e16, 1e19, (4, 30)).astype(np.float32)
    inch = (rng.uniform(size=(4, 30)) > 0.3).astype(np.float32)
    cw = rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
    cj, ct = jcfg.SolverConfig(wall_loss_type=wall), tcfg.SolverConfig(wall_loss_type=wall)
    ref = np.asarray(jsolver.wall_energy_loss_rate(Te, ne, inch, cw, cj))
    got = tsolver.wall_energy_loss_rate(t(Te), t(ne), t(inch), t(cw), ct).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-3)
