"""Port against the JAX package: the K-step and one-step discharge solvers.

The plain PyTorch versions of the CUDA kernels (``fused_step.kstep_plain`` and
``fused_step.step_plain``) are held against the TPU kernels
``build_multistep_kernel`` and ``build_step_kernel`` run in Pallas interpret
mode, state for state, with one and two neutral groups and with the I_d(t)
trace lanes; the time loop ``simulate_batch_multi`` against
``simulate_batch_pallas_multi`` on its time-averaged QoIs and traces.

Tolerances: after 1 and 37 steps every state array, profile sum, accumulator and
one-step output agrees to rtol 1e-4, with an absolute floor of 1e-6 of the
array's largest magnitude (momenta cross zero); the spread comes from float32
rounding and the summation order of the lane reductions. Run QoIs agree within
1%, the bound of tests/test_pallas.py for the kernel against the lax solver;
discharge-current traces within 1e-5 relative, and their sample times exactly."""

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
    """Both packages' configs and the same params and B-field (JAX numpy, torch CPU)."""
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


def _jax_state_list(st, ncharge, groups):
    out = [st["rho_n"], st["nE"]] + [a for z in range(ncharge) for a in (st["rho_i"][z], st["mom_i"][z])]
    return out + ([st["rho_n2"]] if groups == 2 else [])


@pytest.mark.parametrize("ncharge,K,i0,groups,num_save", [
    pytest.param(1, 1, 1240, 1, 0, id="1-1-1240"), pytest.param(3, 1, 1240, 1, 0, id="3-1-1240"),
    pytest.param(1, 37, 1240, 1, 0, id="1-37-1240"), pytest.param(3, 37, 1240, 1, 0, id="3-37-1240"),
    pytest.param(3, 37, 2480, 1, 0, id="3-37-2480"),
    pytest.param(1, 37, 1240, 2, 0, id="1-37-1240-two_group"),
    pytest.param(2, 37, 1240, 2, 0, id="2-37-1240-two_group"),
    pytest.param(1, 37, 1240, 1, 40, id="1-37-1240-trace"),
    pytest.param(2, 37, 1240, 1, 40, id="2-37-1240-trace"),
])
def test_kstep_plain_matches_pallas_kernel(ncharge, K, i0, groups, num_save):
    """One K-step block from the same state: state for state. i0 = 1240 crosses
    the start of the averaging window (1250); i0 = 2480 overshoots the end (2500)."""
    B = 8
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, 2500, B, neutral_groups=groups, num_save=num_save)
    consts = ps._pack_consts(pj, jnp.asarray(base_B), cj)
    st = ps._initial_state(pj, cj)
    st.pop("icir")
    n_prof = ncharge + 4
    LN = ps.lanes_for(cj)
    prof = [jnp.zeros((B, LN), jnp.float32) for _ in range(n_prof)]
    sacc = jnp.zeros((B, 128), jnp.float32).at[:, ps._A_ICIR].set((ps._E / cj.mi) * pj["mdot_a"])
    stepK = ps.build_multistep_kernel(cj, K, interpret=True, tile_b=8, trace=num_save > 0)
    j_state, j_prof, j_sacc = stepK(st, prof, sacc, consts, i0)

    tconsts, state, tprof, tsacc = fs.init_carry(pt, bt, ct)
    fs.kstep(state, tprof, tsacc, tconsts, i0, K, ct)
    jl = _jax_state_list(j_state, ncharge, groups)
    assert state.shape[0] == len(jl)
    for j, a in enumerate(jl):
        _close(state[j].numpy(), a, f"state {j}")
    for j, a in enumerate(j_prof):
        _close(tprof[j].numpy(), a, f"prof {j}")
    slots = list(range(8)) + ([ps._A_TRACE0 + k for k in range(K)] if num_save else [])
    for slot in slots:
        _close(tsacc[:, slot].numpy(), np.asarray(j_sacc)[:, slot], f"sacc {slot}")


@pytest.mark.parametrize("ncharge,groups,plume", [(1, 1, True), (3, 1, True), (1, 2, True), (2, 2, False)])
def test_step_plain_matches_pallas_step_kernel(ncharge, groups, plume):
    """One step of the one-step kernel from the same state: every state array and
    all five output arrays (j_d/qs_t/qs_f lanes, Te, ne, E, nn)."""
    B = 8
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, 2500, B, plume=plume, neutral_groups=groups)
    consts = ps._pack_consts(pj, jnp.asarray(base_B), cj)
    st = ps._initial_state(pj, cj)
    st.pop("icir")
    j_state, j_ex = ps.build_step_kernel(cj, interpret=True, tile_b=8)(st, consts)

    tconsts, state, _, tsacc = fs.init_carry(pt, bt, ct)
    tconsts["scalars"][:, fs.P_ICIR] = tsacc[:, fs.A_ICIR]
    extras = torch.zeros((5, B, fs.lanes_for(ct)))
    fs.step(state, extras, tconsts, ct)
    for j, a in enumerate(_jax_state_list(j_state, ncharge, groups)):
        _close(state[j].numpy(), a, f"state {j}")
    for lane, key in enumerate(("j_d", "qs_t", "qs_f")):
        _close(extras[0, :, lane].numpy(), j_ex[key], key)
    for j, key in enumerate(("Te", "ne", "E", "nn")):
        _close(extras[1 + j].numpy(), j_ex[key], key)


@pytest.mark.parametrize("ncharge,B,nsteps,groups", [
    pytest.param(1, 11, 800, 1, id="1-11-800"), pytest.param(3, 5, 400, 1, id="3-5-400"),
    pytest.param(1, 8, 600, 2, id="1-8-600-two_group"), pytest.param(2, 5, 400, 2, id="2-5-400-two_group"),
])
def test_simulate_batch_multi_matches_pallas_multi(ncharge, B, nsteps, groups):
    """Whole time loop, odd K = 37 with step-count overshoot; B = 11 is no multiple
    of the TPU kernel's batch tile, which pads it."""
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, nsteps, B, neutral_groups=groups)
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


@pytest.mark.parametrize("ncharge,nsteps,num_save,inner", [
    (1, 400, 40, 37),    # stride 10: a few save points in each launch
    (2, 300, 40, 200),   # K capped at the 120 trace lanes
    (1, 30, 40, 37),     # fewer steps than save points: stride 1, the tail stays 0
])
def test_trace_matches_pallas_multi(ncharge, nsteps, num_save, inner):
    """The I_d(t) trace of the K-step driver: the save points gathered from the
    trace lanes of each launch, and their sample times."""
    B = 5
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, nsteps, B, num_save=num_save)
    ref = {k: np.asarray(v) for k, v in ps.simulate_batch_pallas_multi(
        pj, jnp.asarray(base_B), cj, inner_steps=inner, calls_per_dispatch=3, interpret=True).items()}
    got = {k: v.numpy() for k, v in fs.simulate_batch_multi(pt, bt, ct, inner_steps=inner).items()}
    assert set(got) == set(ref)
    tr, tr_ref = got["discharge_current_trace"], ref["discharge_current_trace"]
    assert tr.shape == tr_ref.shape == (B, num_save)
    np.testing.assert_allclose(tr, tr_ref, rtol=1e-5, atol=1e-5 * np.max(np.abs(tr_ref)))
    np.testing.assert_array_equal(got["trace_times"], ref["trace_times"])
    i_d, i_d_ref = got["discharge_current"], ref["discharge_current"]
    rel = np.max(np.abs(i_d - i_d_ref) / np.abs(i_d_ref))
    assert rel < 0.01


@pytest.mark.parametrize("num_cells,lanes", [
    (60, 128), (124, 128),              # nc <= 126: 128 lanes
    (125, 160), (156, 160), (158, 192),  # the least multiple of 32 holding nc + 2
    (200, 224), (222, 256), (252, 256),  # fidelity (2,2): 224; the widest grid: 256
])
def test_lanes_for_sizes_the_layout_to_the_warp(num_cells, lanes):
    """The lane width: 128 lanes up to 126 cells with the ghosts, then a warp
    at a time, at least two padding lanes; the packed tensors follow it, and the
    JAX package keeps its TPU layout (256 lanes past 126)."""
    ct = tcfg.SolverConfig(num_cells=num_cells, ncharge=1)
    assert fs.lanes_for(ct) == lanes and lanes % 32 == 0 and lanes >= ct.nc + 2
    assert ps.lanes_for(jcfg.SolverConfig(num_cells=num_cells, ncharge=1)) == (128 if ct.nc <= 126 else 256)
    params = tcfg.make_params({"V_d": torch.full((2,), 300.0)}, device="cpu")
    consts, state, prof, sacc = fs.init_carry(params, torch.full((ct.nc,), 0.015), ct)
    assert state.shape[2] == prof.shape[2] == consts["nu_anom"].shape[1] == consts["omega_ce"].shape[1] == lanes
    assert not state[:, :, ct.nc:].any() and not consts["nu_anom"][:, ct.nc:].any()


def test_grids_wider_than_the_layout_raise():
    """Past 254 cells the lane layout does not fit: the port names the lax path."""
    ct = tcfg.SolverConfig(num_cells=300, ncharge=1)
    with pytest.raises(NotImplementedError, match="lax"):
        fs.check_supported(ct)


def test_float64_configs_raise():
    """The float32 lane layout refuses a dtype="float64" config, naming the lax
    solver; ``dispatch_solver`` runs it there, in float64, and every output
    matches JAX's lax solver (float64, 20 steps) within 1e-12 of its scale."""
    import jax
    from hallthrusterpem_tpu.models.thruster.solver import simulate_batch
    from hallthrusterpem_tpu_torch.models.thruster import dispatch_solver

    nsteps = 20
    cj, ct, pj, base_B, pt, bt = _setup(1, nsteps, 2, dtype="float64")
    with jax.enable_x64(True):
        ref = simulate_batch({k: jnp.asarray(v, jnp.float64) for k, v in pj.items()},
                             jnp.asarray(base_B, jnp.float64), cj)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    assert ref["thrust"].dtype == np.float64 and np.all(np.isfinite(ref["thrust"]))
    with pytest.raises(NotImplementedError, match="lax"):
        fs.check_supported(ct)
    with pytest.raises(NotImplementedError, match="float32"):
        fs.simulate_batch_multi(pt, bt, ct)
    got = dispatch_solver(pt, bt, ct)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].numpy()
        assert g.dtype == r.dtype == np.float64 and g.shape == r.shape, k
        assert np.max(np.abs(g - r)) <= 1e-12 * np.max(np.abs(r)), k


def test_trace_caps_the_launch_length():
    _, ct, _, _, pt, bt = _setup(1, 100, 2, num_save=10)
    consts, state, prof, sacc = fs.init_carry(pt, bt, ct)
    with pytest.raises(ValueError):
        fs.kstep_plain(state, prof, sacc, consts, 0, fs.MAX_TRACE_STEPS + 1, ct)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back to the plain version."""
    _, ct, _, _, pt, bt = _setup(1, 100, 2)
    consts, state, prof, sacc = fs.init_carry(pt, bt, ct)
    with pytest.raises(ValueError):
        _kernels.kstep_cuda(state, prof, sacc, consts, 0, 10, ct)
    with pytest.raises(ValueError):
        fs.kstep(state.to("meta"), prof, sacc, consts, 0, 10, ct)
    extras = torch.zeros((5,) + state.shape[1:])
    with pytest.raises(ValueError):
        _kernels.step_cuda(state, extras, consts, ct)
    with pytest.raises(ValueError):
        fs.step(state.to("meta"), extras, consts, ct)


def test_kernel_params_layout():
    """The ctypes mirror of the kernels' config struct: 14 ints, then floats."""
    ct = tcfg.SolverConfig(num_cells=200, ncharge=3, solve_plume=True, num_save=1000)
    p = _kernels.kernel_params(ct)
    assert _kernels.ctypes.sizeof(p) == 4 * (14 + 45 + 6 * 3 + 6)
    assert (p.NC, p.n_levels, p.solve_plume, p.trace) == (202, 8, 1, 1)
    coef = _kernels.rate_coefficients(ct)
    assert coef.dtype == np.float32 and coef.shape == (7 * 21,)
