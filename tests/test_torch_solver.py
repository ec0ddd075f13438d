"""Port against the JAX package: the lax solver (``models/thruster/solver.py``),
its tables (``rates.py``) and its tridiagonal solvers (``ops/tridiag.py``), and
the routes to it (``dispatch_solver``, ``CoupledPEM``).

The same numpy inputs go to both packages. JAX runs its lax solver as its own
CPU tests do; a float64 config runs under ``jax.enable_x64(True)``.
Tolerances, set from the dtype: the tridiagonal solvers within 1e-6 (float32)
or 1e-13 (float64) of the array's scale, the table lookups as their test says; 5 steps from the same
carry within 1e-5 (float32) or 1e-12 (float64) scaled, array for array (scaled:
max |port - JAX| / max |JAX|); time-averaged thrust, discharge and beam current
within 1% over 2,500 steps, the run-level bound of tests/test_pallas.py; the
chunked run equal to the monolithic one bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hallthrusterpem_tpu.models.thruster import config as jcfg
from hallthrusterpem_tpu.models.thruster import rates as jrates
from hallthrusterpem_tpu.models.thruster import solver as jsol
from hallthrusterpem_tpu.ops import tridiag as jtri
from hallthrusterpem_tpu.pem import CoupledPEM as JaxCoupledPEM
import hallthrusterpem_tpu_torch.models.thruster as tthr
from hallthrusterpem_tpu_torch.models.thruster import _kernels
from hallthrusterpem_tpu_torch.models.thruster import config as tcfg
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
from hallthrusterpem_tpu_torch.models.thruster import rates as trates
from hallthrusterpem_tpu_torch.models.thruster import solver as tsol
from hallthrusterpem_tpu_torch.ops import tridiag as ttri
from hallthrusterpem_tpu_torch.pem import _NOMINALS, CoupledPEM

torch.set_num_threads(2)
STEP_TOL = {"float32": 1e-5, "float64": 1e-12}
NP_DTYPE = {"float32": np.float32, "float64": np.float64}


def _setup(ncharge, nsteps, B, plume=True, **extra):
    """Both packages' 60-cell configs and the same params and B-field (JAX numpy,
    torch CPU), as in tests/test_torch_fused_step.py."""
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


def _scaled(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / max(float(np.max(np.abs(ref))), 1e-300))


def _carry_arrays(carry):
    state, accum, _, failed = carry
    return list(state) + [accum[k] for k in tsol.ACCUM_KEYS] + [failed]


def _systems(n, B, dtype, seed):
    """Random diagonally dominant tridiagonal systems, rows scaled over 12 decades."""
    rng = np.random.default_rng(seed)
    a, c = rng.uniform(-1, 1, (2, B, n))
    b = np.abs(a) + np.abs(c) + rng.uniform(0.5, 2.0, (B, n))
    d = rng.uniform(-1, 1, (B, n))
    scale = 10.0 ** rng.uniform(-6, 6, (B, n))
    return [(x * scale).astype(dtype) for x in (a, b, c, d)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [37, 300])
def test_tridiagonal_solvers_match_jax(n, dtype):
    """PCR (9 levels at 300 rows) and Thomas, against JAX's and against each other."""
    tol = {"float32": 1e-6, "float64": 1e-13}[dtype]
    sys_np = _systems(n, 4, NP_DTYPE[dtype], seed=n)
    with jax.enable_x64(dtype == "float64"):
        ref_pcr = np.asarray(jtri.tridiag_solve(*map(jnp.asarray, sys_np)))
        ref_thomas = np.asarray(jtri.thomas_solve(*map(jnp.asarray, sys_np)))
    sys_t = [torch.as_tensor(x) for x in sys_np]
    pcr = ttri.tridiag_solve(*sys_t)
    thomas = ttri.thomas_solve(*sys_t)
    assert pcr.dtype == thomas.dtype == getattr(torch, dtype)
    assert _scaled(pcr, ref_pcr) < tol
    assert _scaled(thomas, ref_thomas) < tol
    assert _scaled(pcr, thomas.numpy()) < 100 * tol


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rate_tables_match_jax(dtype):
    """Every reaction's table and derivative table, and ``lookup_rate`` over
    temperatures inside, at and beyond both ends of the grid. The lookup's bound
    is set by its grid position: log10 rounded once differently moves the
    position by an ulp (2^-16 near the top of the float32 grid), and one grid
    step changes a table by up to 0.26 of its largest value, so float32 gets
    3e-5 (a few ulps); float64 1e-13."""
    tol = {"float32": 3e-5, "float64": 1e-13}[dtype]
    for jr, tr in zip(jrates.build_reactions("Xenon", 3), trates.build_reactions("Xenon", 3)):
        assert tr.table == jr.table
        np.testing.assert_array_equal(trates.derivative_table(tr), jrates.derivative_table(jr))
    ex_j, ex_t = jrates.excitation_table("Xenon"), trates.excitation_table("Xenon")
    np.testing.assert_array_equal(ex_t[0], ex_j[0])
    assert ex_t[1] == ex_j[1]
    rng = np.random.default_rng(1)
    Te = np.concatenate([10.0 ** rng.uniform(-1, 2.5, 500), [0.1, 0.3, 150.0, 400.0]]).astype(NP_DTYPE[dtype])
    tables = [np.asarray(r.table) for r in trates.build_reactions("Xenon", 3)] + [ex_t[0]]
    tables += [trates.derivative_table(trates.excitation_log_poly("Xenon")[0])]
    for table in tables:
        with jax.enable_x64(dtype == "float64"):
            ref = np.asarray(jrates.lookup_rate(jnp.asarray(table, NP_DTYPE[dtype]), jnp.asarray(Te)))
        got = trates.lookup_rate(torch.as_tensor(table, dtype=getattr(torch, dtype)), torch.as_tensor(Te))
        assert got.dtype == getattr(torch, dtype)
        assert _scaled(got, ref) < tol


@pytest.mark.parametrize("ncharge,groups,plume,dtype", [
    pytest.param(1, 1, True, "float32", id="1-plume-f32"),
    pytest.param(3, 1, True, "float32", id="3-plume-f32"),
    pytest.param(2, 2, False, "float32", id="2-two_group-f32"),
    pytest.param(3, 1, True, "float64", id="3-plume-f64"),
    pytest.param(1, 2, True, "float64", id="1-two_group-f64"),
])
def test_make_step_matches_jax(ncharge, groups, plume, dtype):
    """The initial carry, then 5 steps from the carry JAX reaches after 300 steps:
    the first 5 steps of the averaging window, so the running sums move too."""
    B = 3
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, 600, B, plume, neutral_groups=groups, dtype=dtype)
    with jax.enable_x64(dtype == "float64"):
        jb = jnp.asarray(base_B)
        j0 = jsol._init_batch(pj, jb, cj)
        j_mid = jsol._segment_batch(pj, jb, j0, cj, 300)
        j5 = jsol._segment_batch(pj, jb, j_mid, cj, 5)
        j0, j_mid, j5 = (jax.tree_util.tree_map(np.asarray, c) for c in (j0, j_mid, j5))
    t0 = tsol._init_batch(pt, bt, ct)
    assert t0[2] == 0
    for got, ref in zip(_carry_arrays(t0), _carry_arrays(tsol.carry_from_jax_numpy(j0, "cpu"))):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _scaled(got.double(), ref.double()) < STEP_TOL[dtype]
    t5 = tsol._segment_batch(pt, bt, tsol.carry_from_jax_numpy(j_mid, "cpu"), ct, 5)
    ref5 = tsol.carry_from_jax_numpy(j5, "cpu")
    assert t5[2] == ref5[2] == 305
    for j, (got, ref) in enumerate(zip(_carry_arrays(t5), _carry_arrays(ref5))):
        assert got.dtype == ref.dtype == (torch.bool if ref.dtype == torch.bool else getattr(torch, dtype))
        assert _scaled(got.double(), ref.double()) < STEP_TOL[dtype], j


def test_carry_from_jax_numpy_refuses_mixed_steps():
    cj, ct, pj, base_B, pt, bt = _setup(1, 100, 2)
    carry = jax.tree_util.tree_map(np.asarray, jsol._init_batch(pj, jnp.asarray(base_B), cj))
    carry = (carry[0], carry[1], np.array([0, 1], np.int32), carry[3])
    with pytest.raises(ValueError):
        tsol.carry_from_jax_numpy(carry, "cpu")


@pytest.mark.parametrize("ncharge,groups,plume,num_save", [
    pytest.param(1, 1, True, 0, id="1-plume"),
    pytest.param(3, 1, True, 0, id="3-plume"),
    pytest.param(1, 2, False, 0, id="1-two_group"),
    pytest.param(2, 1, True, 40, id="2-plume-trace"),
])
def test_simulate_batch_matches_jax(ncharge, groups, plume, num_save):
    """2,500 steps: every output with JAX's shape and dtype, the QoIs within 1%,
    the I_d(t) trace within 1e-4 and its times exactly; with three charge states
    also the chunked run (700-step segments, the last overshooting) equal to
    the monolithic one."""
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, 2500, 3, plume, neutral_groups=groups, num_save=num_save)
    ref = {k: np.asarray(v) for k, v in jsol.simulate_batch(pj, jnp.asarray(base_B), cj).items()}
    got = tsol.simulate_batch(pt, bt, ct)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].numpy().dtype == ref[k].dtype, k
    assert np.all(np.isfinite(ref["thrust"]))
    for key in ("thrust", "discharge_current", "ion_current"):
        g, r = got[key].numpy(), ref[key]
        assert np.max(np.abs(g - r) / np.abs(r)) < 0.01, key
    if num_save:
        np.testing.assert_allclose(got["discharge_current_trace"].numpy(), ref["discharge_current_trace"],
                                   rtol=1e-4)
        np.testing.assert_array_equal(got["trace_times"].numpy(), ref["trace_times"])
    elif ncharge == 3:
        chunked = tsol.simulate_batch_chunked(pt, bt, ct, chunk_steps=700)
        assert set(chunked) == set(got)
        for k in got:
            assert torch.equal(chunked[k], got[k]), k


@pytest.mark.parametrize("nsteps,num_save", [
    pytest.param(155, 200, id="more_saves_than_steps"),
    pytest.param(500, 37, id="stride_13_with_a_tail"),
])
def test_step_index_and_trace_match_jax(nsteps, num_save):
    """The step index is a 0-d int64 tensor of the carry (the averaging gate and
    the trace write are tensor expressions of it), and the trace goes through a
    buffer with one spare column: the outputs and the trace equal JAX's
    ``simulate_batch``'s, with more save points than steps (the columns past the
    last step stay zero, as in JAX's lax solver) and with off-stride steps after
    the last save point."""
    cj, ct, pj, base_B, pt, bt = _setup(3, nsteps, 3, num_save=num_save)
    carry = tsol._init_batch(pt, bt, ct)
    assert carry[2].dtype == torch.int64 and carry[2].ndim == 0 and int(carry[2]) == 0
    trace = torch.full((3, num_save + 1), -1.0)
    end = tsol._segment_batch(pt, bt, carry, ct, nsteps, trace)
    assert int(end[2]) == nsteps and int(carry[2]) == 0
    written = torch.arange(num_save) * max(1, nsteps // num_save) < nsteps
    assert (trace[:, :num_save][:, ~written] == -1.0).all() and (trace[:, :num_save][:, written] != -1.0).all()
    ref = {k: np.asarray(v) for k, v in jsol.simulate_batch(pj, jnp.asarray(base_B), cj).items()}
    got = tsol.simulate_batch(pt, bt, ct)
    assert np.all(np.isfinite(ref["thrust"]))
    for key in ("thrust", "discharge_current", "ion_current"):
        assert np.max(np.abs(got[key].numpy() - ref[key]) / np.abs(ref[key])) < 0.01, key
    tr, rtr = got["discharge_current_trace"].numpy(), ref["discharge_current_trace"]
    assert tr.shape == rtr.shape == (3, num_save)
    np.testing.assert_array_equal(tr[:, ~written.numpy()], rtr[:, ~written.numpy()])
    assert (rtr[:, ~written.numpy()] == 0).all()
    np.testing.assert_allclose(tr, rtr, rtol=1e-4)
    np.testing.assert_array_equal(got["trace_times"].numpy(), ref["trace_times"])


def test_failed_rows_are_nan():
    """A blow-up row (a 3e9 V discharge) is flagged per row and comes back NaN,
    as in JAX; the other rows stay finite."""
    cj, ct, pj, base_B, pt, bt = _setup(1, 300, 3)
    pt = dict(pt, V_d=pt["V_d"].clone())
    pt["V_d"][1] = 3e9
    pj = dict(pj, V_d=jnp.asarray(pt["V_d"].numpy()))
    ref = jsol.simulate_batch(pj, jnp.asarray(base_B), cj)
    got = tsol.simulate_batch(pt, bt, ct)
    np.testing.assert_array_equal(np.isfinite(got["thrust"].numpy()), np.isfinite(np.asarray(ref["thrust"])))
    assert torch.isfinite(got["thrust"]).tolist() == [True, False, True]
    assert torch.isnan(got["ui"][1]).all() and torch.isfinite(got["ui"][0]).all()


@pytest.mark.parametrize("dtype,num_cells", [("float32", 300), ("float64", 60)])
def test_dispatch_routes_to_lax(dtype, num_cells, monkeypatch):
    """Past 254 cells and in float64 ``dispatch_solver`` runs the lax solver on the
    CPU tensors it is given, launching no kernel and running no K-step block;
    ``chunk_steps`` splits its loop. A float32 config of 60 cells stays on the
    K-step path."""
    cfg = tcfg.SolverConfig(num_cells=num_cells, dt=1e-8, duration=6e-8, average_start_time=0.0,
                            dtype=dtype)
    params = tcfg.make_params({"V_d": torch.tensor([290.0, 310.0]), "V_cc": 30.0})
    base_B = torch.full((cfg.nc,), 0.01)
    blocks, segments = [], []
    monkeypatch.setattr(tthr.fs, "kstep_plain", lambda *a: blocks.append(1))
    monkeypatch.setattr(tthr.solver, "_segment_batch",
                        lambda *a, _f=tthr.solver._segment_batch, **k: segments.append(a[4]) or _f(*a, **k))
    _kernels.reset_counts()
    out = tthr.dispatch_solver(params, base_B, cfg)
    assert out["thrust"].dtype == getattr(torch, dtype) and out["thrust"].device.type == "cpu"
    assert not blocks and segments == [6] and _kernels.launch_counts == {"kstep": 0, "step": 0}
    chunked = tthr.dispatch_solver(params, base_B, cfg, chunk_steps=4)
    assert segments == [6, 4, 4]
    for k in out:
        assert torch.equal(chunked[k], out[k]), k
    small = dataclasses.replace(cfg, num_cells=60, dtype="float32")
    tthr.dispatch_solver(params, torch.full((small.nc,), 0.01), small)
    assert blocks and segments == [6, 4, 4]


def _pem_inputs(B, seed=0, spread=0.08):
    rng = np.random.default_rng(seed)
    return {k: (v * (1 + spread * rng.uniform(-1, 1, B))).astype(np.float32) for k, v in _NOMINALS.items()}


def test_coupled_pem_past_the_kernel_layout_matches_jax():
    """``CoupledPEM`` at 260 cells (B = 2, 20 steps) runs the lax solver and equals
    JAX's ``CoupledPEM`` (lax on the CPU): T, I_d and I_B0 within 1e-5, every
    other output within 1e-5 of its scale (``I_d_std``, a small difference of
    float32 sums, within 1e-5 of I_d); ``chunk_steps`` changes no number."""
    kw = dict(thruster="SPT-100", model_fidelity=(2, 2), duration=20 * 2e-9,
              simulation={"num_cells": 260, "dt": 2e-9})
    x = _pem_inputs(2)
    ref = {k: np.asarray(v) for k, v in JaxCoupledPEM(**kw)({k: jnp.asarray(v) for k, v in x.items()}).items()}
    pem = CoupledPEM(**kw, device="cpu")
    assert tthr.uses_lax_solver(pem.cfg) and pem.cfg.nc == 262
    xt = {k: torch.as_tensor(v) for k, v in x.items()}
    got = {k: v.numpy() for k, v in pem(xt).items()}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        if k in ("T", "I_d", "I_B0"):
            assert np.max(np.abs(got[k] - ref[k]) / np.abs(ref[k])) < 1e-5, k
        elif k == "I_d_std":
            assert np.max(np.abs(got[k] - ref[k])) < 1e-5 * np.max(np.abs(ref["I_d"])), k
        else:
            assert _scaled(got[k], ref[k]) < 1e-5, k
    chunked = pem(xt, chunk_steps=7)
    for k in got:
        np.testing.assert_array_equal(chunked[k].numpy(), got[k], err_msg=k)


def test_run_simulation_past_the_kernel_layout_matches_jax():
    """The wrapper reaches the lax solver unchanged: a 260-cell tree (40 steps,
    10 save points, the cycle average) through both packages' ``run_simulation``
    (JAX on its lax solver): the QoIs and the I_d(t) trace within 1e-5, the
    step-level float32 bound, and the trace times exactly."""
    import hallthrusterpem_tpu.models.thruster as jthr
    from hallthrusterpem_tpu.models.thruster import mapping as jmap
    from hallthrusterpem_tpu_torch.models.thruster import mapping as tmap

    comp = {"config": {"discharge_voltage": 300, "anode_mass_flow_rate": 5e-6, "ncharge": 1, "solve_plume": True,
                       "apply_thrust_divergence_correction": True, "circuit": {"R": 0.5, "L": 0.0},
                       "anom_model": {"type": "LogisticPressureShift", "dz": 0.2, "z0": -0.03, "pstar": 45e-6,
                                      "alpha": 15, "model": {"type": "TwoZoneBohm", "c1": 0.00625, "c2": 0.0625}}},
            "simulation": {"dt": 2e-9, "duration": 40 * 2e-9, "num_save": 10, "grid": {"num_cells": 260}},
            "postprocess": {"average_start_time": 20 * 2e-9, "cycle_average": True}}
    rng = np.random.default_rng(2)
    x = {k: (_NOMINALS[k] * (1 + 0.05 * rng.uniform(-1, 1, 2))).astype(np.float32)
         for k in ("P_b", "V_a", "mdot_a", "T_e", "u_n", "l_t", "a_1", "a_2")}
    x["V_cc"] = np.float32([30.0, 31.0])
    tree_j = jmap.format_input_tree(x, jmap.PEM_TO_JULIA, model_fidelity=None, **comp)
    tree_t = tmap.format_input_tree({k: torch.as_tensor(v) for k, v in x.items()}, tmap.PEM_TO_JULIA,
                                    model_fidelity=None, **comp)
    assert tthr.uses_lax_solver(tthr._tree_to_solver_inputs(tree_t, "cpu")[0])
    ref = jthr.run_simulation(tree_j)["output"]["average"]
    got = tthr.run_simulation(tree_t, device="cpu")["output"]["average"]
    assert set(got) == set(ref)
    for k in ("thrust", "discharge_current", "ion_current", "discharge_current_trace"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape and np.max(np.abs(g - r) / np.abs(r)) < 1e-5, k
    np.testing.assert_array_equal(got["trace_times"].numpy(), np.asarray(ref["trace_times"]))
