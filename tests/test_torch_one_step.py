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


def _python_loop_reference(params, base_B, cfg, chunk_steps=0):
    """The driver as it was before its loop was made ready for CUDA graphs: the
    averaging weight a Python float of a Python step index, the circuit current
    a new tensor each step. The graph-ready loop must equal it bit for bit."""
    _E = 1.602176634e-19
    params = {k: v.to(torch.float32) for k, v in params.items()}
    consts, state, prof, sacc = fs.init_carry(params, base_B, cfg)
    physics = fs.Physics(cfg)
    Z, NC, mi = cfg.ncharge, cfg.nc, cfg.mi
    A_ch = cfg.geometry.channel_area
    a_i2 = 1.380649e-23 * cfg.ion_temp_K / mi
    rho_floor = 1e10 * mi
    ex = NC - 2
    B = state.shape[1]
    extras = torch.empty((5, B, fs.lanes_for(cfg)), dtype=torch.float32)
    scal_icir = consts["scalars"][:, fs.P_ICIR]
    icir = sacc[:, fs.A_ICIR].clone()
    failed = torch.zeros(B, dtype=torch.bool)
    n_steps = cfg.num_steps
    if chunk_steps and cfg.num_steps > chunk_steps:
        n_steps = -(-cfg.num_steps // chunk_steps) * chunk_steps
    for i in range(n_steps):
        scal_icir.copy_(icir)
        fs.step_plain(state, extras, consts, cfg, physics)
        j_d, qs_t, qs_f = extras[0, :, 0], extras[0, :, 1], extras[0, :, 2]
        icir = j_d * A_ch
        thrust = I_B0 = mdot_ion = 0.0
        for z in range(Z):
            r, m = state[2 + 2 * z, :, ex], state[3 + 2 * z, :, ex]
            u = m / torch.clamp(r, min=rho_floor)
            thrust = thrust + A_ch * (m * u + r * a_i2)
            I_B0 = I_B0 + (A_ch * _E * (z + 1)) * r / mi * u
            mdot_ion = mdot_ion + A_ch * m
            if z == 0:
                u_exit1 = u
        if cfg.solve_plume:
            thrust, I_B0, mdot_ion = thrust * qs_t, I_B0 * qs_f, mdot_ion * qs_f
        I_d = j_d * A_ch
        failed |= ~torch.isfinite(I_d) | ~torch.isfinite(state).all(dim=2).all(dim=0)
        w = float(cfg.avg_start_step <= i < cfg.num_steps)
        sacc[:, fs.A_THRUST] += w * thrust
        sacc[:, fs.A_ID] += w * I_d
        sacc[:, fs.A_ID2] += w * I_d * I_d
        sacc[:, fs.A_IB0] += w * I_B0
        sacc[:, fs.A_MDOT] += w * mdot_ion
        sacc[:, fs.A_UEXIT] += w * u_exit1
        prof[:Z] += w * (state[3 : 3 + 2 * Z : 2] / torch.clamp(state[2 : 2 + 2 * Z : 2], min=rho_floor))
        prof[Z:] += w * extras[1:]
    sacc[:, fs.A_FAILED] = failed.float()
    return fs.finalize(params, sacc, prof, consts, base_B, cfg)


@pytest.mark.parametrize("ncharge,B,nsteps,groups,chunk,blow_up_row", [
    (1, 6, 150, 1, 0, None),
    (3, 5, 200, 1, 64, None),   # chunked: the steps past num_steps run unaveraged
    (2, 4, 120, 2, 0, None),    # two neutral groups
    (1, 3, 150, 1, 0, 1),       # a runaway row
])
def test_graph_ready_loop_equals_python_loop(ncharge, B, nsteps, groups, chunk, blow_up_row):
    """The loop with its step index and averaging weight on the device, run
    eagerly on the CPU, equals the Python-indexed loop bit for bit, and JAX's
    ``simulate_batch_pallas`` (interpret mode) within the 1% of the cases above."""
    cj, ct, pj, base_B, pt, bt = _setup(ncharge, nsteps, B, groups, blow_up_row=blow_up_row)
    got = simulate_batch_step(pt, bt, ct, chunk_steps=chunk)
    ref = _python_loop_reference(pt, bt, ct, chunk_steps=chunk)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(torch.isnan(got[k]), torch.isnan(ref[k])), k
        assert torch.equal(torch.nan_to_num(got[k]), torch.nan_to_num(ref[k])), k
    jax_ref = {k: np.asarray(v) for k, v in ps.simulate_batch_pallas(
        pj, jnp.asarray(base_B), cj, interpret=True, chunk_steps=chunk).items()}
    _compare({k: v.numpy() for k, v in got.items()}, jax_ref)


def test_eager_flag_is_the_same_loop_on_cpu():
    """``graphs=False`` and the default run the same loop on the CPU (graphs are
    captured only on a CUDA device), with ``num_steps`` step calls."""
    _, ct, _, _, pt, bt = _setup(1, 90, 3)
    calls = [0]

    def counting(state, extras, consts, cfg, physics):
        calls[0] += 1
        fs.step_plain(state, extras, consts, cfg, physics)

    a = simulate_batch_step(pt, bt, ct, block=counting)
    b = simulate_batch_step(pt, bt, ct, graphs=False)
    assert calls[0] == ct.num_steps
    for k in a:
        assert torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k])), k


def test_replay_schedule_never_overshoots(monkeypatch):
    """``one_step._replay``'s schedule on the CPU, with a stand-in for the
    capture whose replay runs the captured function again: one eager step, then
    graphs of ``GRAPH_STEPS`` steps and one of the remainder, exactly n steps."""
    from hallthrusterpem_tpu_torch import cuda_graph
    from hallthrusterpem_tpu_torch.models.thruster import one_step

    sizes = []

    class Replayed:
        def __init__(self, body):
            self.body = body

        def replay(self):
            self.body()

    def stand_in(body, device, warmup=None):
        before = calls[0]
        body()  # what the capture records
        sizes.append(calls[0] - before)
        calls[0] = before  # a capture runs nothing on the card
        return Replayed(body)

    monkeypatch.setattr(cuda_graph, "capture", stand_in)
    G = one_step.GRAPH_STEPS
    for n, want in ((1, []), (2, [1]), (G + 1, [G]), (2 * G + 38, [G, 37]), (G // 2, [G // 2 - 1])):
        calls, sizes[:] = [0], []
        one_step._replay(lambda: calls.__setitem__(0, calls[0] + 1), n, "cpu")
        assert calls[0] == n and sizes == want, (n, calls, sizes)


def test_launch_count_under_capture_counts_at_each_replay():
    """``cuda_graph.count`` while a capture records: nothing is counted then,
    the graph keeps the launches and adds them at each replay."""
    import threading

    from hallthrusterpem_tpu_torch import cuda_graph

    counts, lock = {"step": 0, "kstep": 0}, threading.Lock()
    cuda_graph.count(counts, "step", lock)
    tally = {}
    cuda_graph._local.tally = tally
    try:
        for name in ("step", "step", "kstep", "step"):
            cuda_graph.count(counts, name, lock)
    finally:
        cuda_graph._local.tally = None
    assert counts == {"step": 1, "kstep": 0}

    class Recorded:
        replays = 0

        def replay(self):
            self.replays += 1

    graph = cuda_graph.Graph(Recorded(), tally, None)
    assert graph.launches == {"step": 3, "kstep": 1}
    graph.replay()
    graph.replay()
    assert counts == {"step": 7, "kstep": 2} and graph._graph.replays == 2
