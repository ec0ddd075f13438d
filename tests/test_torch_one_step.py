"""Port against the JAX package: the one-step discharge driver.

``one_step.simulate_batch_step`` (one launch per step, time averages accumulated
on the host side) is held against ``simulate_batch_pallas`` with the TPU kernel
``build_step_kernel`` in Pallas interpret mode. Tolerance: time-averaged T, I_d
and I_B0 within 1%, the run-level bound of tests/test_pallas.py; the finite
masks equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hallthrusterpem_tpu.models.thruster import config as jcfg
from hallthrusterpem_tpu.models.thruster import pallas_step as ps
from hallthrusterpem_tpu_torch.models.thruster import config as tcfg
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
from hallthrusterpem_tpu_torch.models.thruster.one_step import simulate_batch_step

torch.set_num_threads(2)


def _setup(ncharge, nsteps, B, groups=1, blow_up_row=None):
    kw = dict(num_cells=60, ncharge=ncharge, dt=8e-9, duration=nsteps * 8e-9,
              average_start_time=nsteps // 2 * 8e-9, solve_plume=True,
              apply_thrust_divergence_correction=True, neutral_groups=groups)
    cj, ct = jcfg.SolverConfig(**kw), tcfg.SolverConfig(**kw)
    z = cj.cell_centers()
    s = np.where(z < 0.025, 0.011, 0.018)
    base_B = (0.016 * np.exp(-0.5 * ((z - 0.025) / s) ** 2)).astype(np.float32)
    vd = np.linspace(285, 315, B).astype(np.float32)
    mdot = np.full(B, 5e-6, np.float32)
    if blow_up_row is not None:  # huge voltage and starved flow: the row blows up
        vd[blow_up_row], mdot[blow_up_row] = 3e7, 1e-9
    pj = jcfg.make_params({"V_d": vd, "V_cc": 30.0, "mdot_a": mdot, "P_b": 1e-5})
    pt, bt = fs.from_jax_numpy({k: np.asarray(v) for k, v in pj.items()}, base_B, "cpu")
    return cj, ct, pj, base_B, pt, bt


def _compare(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    np.testing.assert_array_equal(np.isfinite(got["thrust"]), np.isfinite(ref["thrust"]))
    ok = np.isfinite(ref["thrust"])
    assert ok.any()
    for key in ("thrust", "discharge_current", "ion_current"):
        rel = np.max(np.abs(got[key][ok] - ref[key][ok]) / np.abs(ref[key][ok]))
        assert rel < 0.01, (key, rel)


@pytest.mark.parametrize("ncharge,B,nsteps,groups,chunk", [
    (1, 11, 300, 1, 0),    # B = 11: the JAX driver pads it to its batch tile
    (3, 5, 200, 1, 64),    # chunked: the last chunk overshoots num_steps
    (2, 5, 200, 2, 0),     # two neutral groups
])
def test_simulate_batch_step_matches_pallas(ncharge, B, nsteps, groups, chunk):
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, nsteps, B, groups)
    ref = {k: np.asarray(v) for k, v in ps.simulate_batch_pallas(
        pj, jnp.asarray(base_B), cj, interpret=True, chunk_steps=chunk).items()}
    got = {k: v.numpy() for k, v in simulate_batch_step(pt, bt, ct, chunk_steps=chunk).items()}
    assert np.all(np.isfinite(got["thrust"]))
    _compare(got, ref)


def test_blow_up_row_matches():
    """A runaway row (huge voltage, starved flow): the scrub at every step keeps its
    state in range, so it comes back finite but absurd (thrust ~5e15 N) in both
    packages; the thruster wrapper's guards turn such rows into NaN."""
    cj, ct, pj, base_B, pt, bt = _setup(1, 300, 3, blow_up_row=1)
    ref = {k: np.asarray(v) for k, v in ps.simulate_batch_pallas(pj, jnp.asarray(base_B), cj,
                                                                 interpret=True).items()}
    got = {k: v.numpy() for k, v in simulate_batch_step(pt, bt, ct).items()}
    assert got["thrust"][1] > 1e12
    _compare(got, ref)


def test_only_the_all_state_check_catches_a_scrubbed_blow_up():
    """A momentum that turns infinite in one step is scrubbed at the next step's
    entry before the current is computed, so the discharge current stays finite
    throughout; only the per-step all-state check marks the row failed."""
    _, ct, _, _, pt, bt = _setup(1, 120, 3)
    calls, j_d_finite = [0], []

    def poisoning_step(state, extras, consts, cfg, physics):
        fs.step_plain(state, extras, consts, cfg, physics)
        j_d_finite.append(bool(torch.isfinite(extras[0, :, 0]).all()))
        calls[0] += 1
        if calls[0] == 40:
            state[3, 1, 10] = float("inf")

    got = simulate_batch_step(pt, bt, ct, block=poisoning_step)
    clean = simulate_batch_step(pt, bt, ct)
    assert all(j_d_finite) and calls[0] == ct.num_steps
    assert not torch.isfinite(got["thrust"][1])
    for row in (0, 2):
        assert torch.equal(got["thrust"][row], clean["thrust"][row])
