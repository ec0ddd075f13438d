"""Port against the JAX package: the K-step discharge solver.

The plain PyTorch version of the CUDA kernel (``fused_step.kstep_plain``) is held
against the TPU kernel ``build_multistep_kernel`` run in Pallas interpret mode,
state for state, and the time loop ``simulate_batch_multi`` against
``simulate_batch_pallas_multi`` on its time-averaged QoIs.

Tolerances: after 1 and 37 steps every state array, profile sum and accumulator
agrees to rtol 1e-4, with an absolute floor of 1e-6 of the array's largest
magnitude (momenta cross zero); the spread comes from float32 rounding and the
summation order of the lane reductions. Run QoIs agree within 1%, the bound of
tests/test_pallas.py for the kernel against the lax solver."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hallthrusterpem_tpu.models.thruster import config as jcfg
from hallthrusterpem_tpu.models.thruster import pallas_step as ps
from hallthrusterpem_tpu_torch.models.thruster import _kernels
from hallthrusterpem_tpu_torch.models.thruster import config as tcfg
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs

torch.set_num_threads(2)


def _setup(ncharge, nsteps, B, plume=True, **extra):
    kw = dict(num_cells=60, ncharge=ncharge, dt=8e-9, duration=nsteps * 8e-9,
              average_start_time=nsteps // 2 * 8e-9, solve_plume=plume,
              apply_thrust_divergence_correction=plume, **extra)
    cj, ct = jcfg.SolverConfig(**kw), tcfg.SolverConfig(**kw)
    z = cj.cell_centers()
    s = np.where(z < 0.025, 0.011, 0.018)
    base_B = (0.016 * np.exp(-0.5 * ((z - 0.025) / s) ** 2)).astype(np.float32)
    vd = np.linspace(285, 315, B).astype(np.float32)
    pj = jcfg.make_params({"V_d": vd, "V_cc": 30.0, "mdot_a": 5e-6, "P_b": 1e-5})
    pt, bt = fs.from_jax_numpy({k: np.asarray(v) for k, v in pj.items()}, base_B, "cpu")
    return cj, ct, pj, base_B, pt, bt


def _close(got, ref, name, rtol=1e-4):
    ref = np.asarray(ref)
    atol = 1e-6 * max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def test_consts_and_initial_state_match():
    cj, ct, pj, base_B, pt, bt = _setup(3, 100, 5)
    ref = ps._pack_consts(pj, jnp.asarray(base_B), cj)
    consts, state, prof, sacc = fs.init_carry(pt, bt, ct)
    for k in ("nu_anom", "omega_ce"):
        np.testing.assert_allclose(consts[k].numpy(), np.asarray(ref[k]), rtol=2e-6, err_msg=k)
    # the port packs the slots its kernel reads; the circuit current lives in sacc
    used = fs.P_LDT + 1
    np.testing.assert_allclose(consts["scalars"][:, :used].numpy(), np.asarray(ref["scalars"])[:, :used],
                               rtol=2e-6, err_msg="scalars")
    assert not consts["scalars"][:, used:].any()
    st = ps._initial_state(pj, cj)
    jstate = [st["rho_n"], st["nE"]] + [a for z in range(3) for a in (st["rho_i"][z], st["mom_i"][z])]
    assert state.shape == (len(jstate), 5, ps.lanes_for(cj))
    for j, a in enumerate(jstate):
        np.testing.assert_allclose(state[j].numpy(), np.asarray(a), rtol=1e-6, err_msg=str(j))
    np.testing.assert_allclose(sacc[:, fs.A_ICIR].numpy(), np.asarray(st["icir"]), rtol=1e-7)


@pytest.mark.parametrize("ncharge,K,i0", [(1, 1, 1240), (3, 1, 1240), (1, 37, 1240), (3, 37, 1240),
                                          (3, 37, 2480)])
def test_kstep_plain_matches_pallas_kernel(ncharge, K, i0):
    """One K-step block from the same state: state for state. i0 = 1240 crosses
    the start of the averaging window (1250); i0 = 2480 overshoots the end (2500)."""
    B = 8
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, 2500, B)
    consts = ps._pack_consts(pj, jnp.asarray(base_B), cj)
    st = ps._initial_state(pj, cj)
    st.pop("icir")
    n_prof = ncharge + 4
    LN = ps.lanes_for(cj)
    prof = [jnp.zeros((B, LN), jnp.float32) for _ in range(n_prof)]
    sacc = jnp.zeros((B, 128), jnp.float32).at[:, ps._A_ICIR].set((ps._E / cj.mi) * pj["mdot_a"])
    stepK = ps.build_multistep_kernel(cj, K, interpret=True, tile_b=8)
    j_state, j_prof, j_sacc = stepK(st, prof, sacc, consts, i0)

    tconsts, state, tprof, tsacc = fs.init_carry(pt, bt, ct)
    fs.kstep(state, tprof, tsacc, tconsts, i0, K, ct)
    jl = [j_state["rho_n"], j_state["nE"]]
    jl += [a for z in range(ncharge) for a in (j_state["rho_i"][z], j_state["mom_i"][z])]
    for j, a in enumerate(jl):
        _close(state[j].numpy(), a, f"state {j}")
    for j, a in enumerate(j_prof):
        _close(tprof[j].numpy(), a, f"prof {j}")
    for slot in range(8):
        _close(tsacc[:, slot].numpy(), np.asarray(j_sacc)[:, slot], f"sacc {slot}")


@pytest.mark.parametrize("ncharge,B,nsteps", [(1, 11, 800), (3, 5, 400)])
def test_simulate_batch_multi_matches_pallas_multi(ncharge, B, nsteps):
    """Whole time loop, odd K = 37 with step-count overshoot; B = 11 is no multiple
    of the TPU kernel's batch tile, which pads it."""
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, nsteps, B)
    ref = {k: np.asarray(v) for k, v in ps.simulate_batch_pallas_multi(
        pj, jnp.asarray(base_B), cj, inner_steps=37, calls_per_dispatch=9, interpret=True).items()}
    got = {k: v.numpy() for k, v in fs.simulate_batch_multi(pt, bt, ct, inner_steps=37).items()}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert np.all(np.isfinite(got["thrust"]))
    for key in ("thrust", "discharge_current", "ion_current"):
        rel = np.max(np.abs(got[key] - ref[key]) / np.abs(ref[key]))
        assert rel < 0.01, (key, rel)


def test_failed_rows_are_nan():
    """A blow-up row (huge voltage, starved flow) surfaces as NaN, as in JAX."""
    cj, ct, pj, base_B, pt, bt = _setup(1, 300, 3)
    for p in (pt,):
        p["V_d"] = p["V_d"].clone()
        p["mdot_a"] = p["mdot_a"].clone()
        p["V_d"][1], p["mdot_a"][1] = 3e7, 1e-9
    pj = dict(pj, V_d=jnp.asarray(pt["V_d"].numpy()), mdot_a=jnp.asarray(pt["mdot_a"].numpy()))
    ref = ps.simulate_batch_pallas_multi(pj, jnp.asarray(base_B), cj, inner_steps=37, interpret=True)
    got = fs.simulate_batch_multi(pt, bt, ct, inner_steps=37)
    np.testing.assert_array_equal(np.isfinite(got["thrust"].numpy()), np.isfinite(np.asarray(ref["thrust"])))
    assert not np.isfinite(got["thrust"][1].item())


@pytest.mark.parametrize("extra", [{"neutral_groups": 2}, {"num_save": 40}])
def test_unported_variants_raise(extra):
    _, ct, _, _, pt, bt = _setup(1, 100, 2, **extra)
    with pytest.raises(NotImplementedError):
        fs.simulate_batch_multi(pt, bt, ct)
    with pytest.raises(NotImplementedError):
        _kernels.kernel_params(ct)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back to the plain version."""
    _, ct, _, _, pt, bt = _setup(1, 100, 2)
    consts, state, prof, sacc = fs.init_carry(pt, bt, ct)
    with pytest.raises(ValueError):
        _kernels.kstep_cuda(state, prof, sacc, consts, 0, 10, ct)
    with pytest.raises(ValueError):
        fs.kstep(state.to("meta"), prof, sacc, consts, 0, 10, ct)


def test_kernel_params_layout():
    """The ctypes mirror of the kernel's config struct: 13 ints, then floats."""
    ct = tcfg.SolverConfig(num_cells=200, ncharge=3, solve_plume=True)
    p = _kernels.kernel_params(ct)
    assert _kernels.ctypes.sizeof(p) == 4 * (13 + 41 + 6 * 3 + 6)
    assert (p.NC, p.n_levels, p.solve_plume) == (202, 8, 1)
    coef = _kernels.rate_coefficients(ct)
    assert coef.dtype == np.float32 and coef.shape == (7 * 21,)
