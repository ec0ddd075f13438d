"""Port against the JAX package: the coupled PEM (cathode -> K-step solver ->
plume) on the same numpy inputs.

On the CPU the JAX ``CoupledPEM.__call__`` takes its lax route, so the JAX side
is composed by hand from its Pallas branch: ``_pre``, then
``simulate_batch_pallas_multi`` in interpret mode, then ``_post``. Tolerances:
T, I_d and I_B0 within 1% (the run-level bound of tests/test_pallas.py); V_cc
and j_ion, which are closed-form in the inputs and I_B0, within rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hallthrusterpem_tpu.models.thruster.pallas_step import simulate_batch_pallas_multi
from hallthrusterpem_tpu.pem import CoupledPEM as JaxCoupledPEM
from hallthrusterpem_tpu_torch.pem import _NOMINALS, CoupledPEM, default_coupled_inputs

torch.set_num_threads(2)
KW = dict(thruster="SPT-100", model_fidelity=(2, 2), duration=500 * 8e-9,
          simulation={"num_cells": 60, "dt": 8e-9})


def _inputs(B, seed=0, spread=0.08):
    rng = np.random.default_rng(seed)
    return {k: (v * (1 + spread * rng.uniform(-1, 1, B))).astype(np.float32) for k, v in _NOMINALS.items()}


@pytest.fixture(scope="module")
def outputs():
    x = _inputs(8)
    jpem = JaxCoupledPEM(**KW)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    solver_params, v_cc = jpem._pre(jx)
    sol = simulate_batch_pallas_multi(solver_params, jpem.base_B, jpem.cfg, interpret=True)
    ref = {k: np.asarray(v) for k, v in jpem._post(jx, v_cc, sol, sweep_radius=jpem.sweep_radius).items()}
    pem = CoupledPEM(**KW, device="cpu")
    assert (pem.cfg.nc, pem.cfg.ncharge, pem.cfg.num_steps) == (jpem.cfg.nc, jpem.cfg.ncharge, jpem.cfg.num_steps)
    got = {k: v.numpy() for k, v in pem({k: torch.as_tensor(v) for k, v in x.items()}).items()}
    return got, ref


def test_coupled_outputs_match(outputs):
    got, ref = outputs
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert np.all(np.isfinite(got["T"]))
    for key in ("T", "I_d", "I_B0"):
        rel = np.max(np.abs(got[key] - ref[key]) / np.abs(ref[key]))
        assert rel < 0.01, (key, rel)
    np.testing.assert_allclose(got["V_cc"], ref["V_cc"], rtol=1e-5)
    np.testing.assert_allclose(got["j_ion"], ref["j_ion"], rtol=1e-5)
    np.testing.assert_allclose(got["u_ion_coords"], ref["u_ion_coords"], rtol=1e-7)


def test_bfield_buffer_matches():
    jpem = JaxCoupledPEM(**KW)
    pem = CoupledPEM(**KW, device="cpu")
    np.testing.assert_allclose(pem.base_B.numpy(), np.asarray(jpem.base_B), rtol=2 ** -23)


@pytest.mark.parametrize("chunk_steps", [0, 500])
def test_chunk_steps_has_no_effect(chunk_steps):
    """``forward`` takes JAX's ``chunk_steps``; the kernel path ignores it, as the
    JAX package's kernel branch does."""
    pem = CoupledPEM(**KW, device="cpu")
    x = {k: torch.as_tensor(v) for k, v in _inputs(3, seed=2).items()}
    ref = pem(x)
    got = pem(x, chunk_steps=chunk_steps)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_example_inputs_match_jax():
    jx = JaxCoupledPEM(**KW).example_inputs(batch=6)
    pem = CoupledPEM(**KW, device="cpu")
    x = pem.example_inputs(batch=6)
    assert set(x) == set(jx)
    for k, v in x.items():
        assert tuple(v.shape) == tuple(jx[k].shape) == (6,), k
        assert v.dtype == torch.float32 and v.device == pem.device, k
    assert tuple(pem.example_inputs()["V_a"].shape) == (16,)
    again = pem.example_inputs(6, torch.Generator().manual_seed(0))
    assert all(torch.equal(x[k], again[k]) for k in x)


def test_default_inputs_and_device_policy(monkeypatch):
    gen = torch.Generator().manual_seed(5)
    x = default_coupled_inputs(16, gen, spread=0.08, device="cpu")
    assert set(x) == set(_NOMINALS)
    for k, v in x.items():
        assert v.shape == (16,) and v.dtype == torch.float32
        lo, hi = sorted((_NOMINALS[k] * 0.92, _NOMINALS[k] * 1.08))
        assert bool(((v >= np.float32(lo)) & (v <= np.float32(hi))).all()), k
    again = default_coupled_inputs(16, torch.Generator().manual_seed(5), spread=0.08, device="cpu")
    assert all(torch.equal(x[k], again[k]) for k in x)
    # without a card and without an explicit device, the port refuses to run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        CoupledPEM(**KW)
    with pytest.raises(RuntimeError):
        default_coupled_inputs(4)
