"""The K-step and one-step CUDA kernels and the plume's kernel on the card
against their plain PyTorch versions; the lax solver on the card against the host CPU, and its replayed
CUDA graphs against its eager route bit for bit; the System path; the
surrogates' products (the MLP ensemble's forward, the tensor interpolant) on the
card against the host CPU.

Run on a machine with a CUDA card: ``python -m pytest -m gpu tests/test_torch_gpu.py``.
Each test decides inside itself whether a card is present and skips otherwise,
so that every test process collects the same tests. Tolerances are those of the
CPU tests: rtol 1e-4 (scaled) state for state after one launch, 1% on the run
QoIs."""

import dataclasses

import pytest
import torch

from hallthrusterpem_tpu_torch import tracing
from hallthrusterpem_tpu_torch.models import plume
from hallthrusterpem_tpu_torch.models.thruster import _kernels
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
from hallthrusterpem_tpu_torch.models.thruster.one_step import simulate_batch_step
from hallthrusterpem_tpu_torch.pem import CoupledPEM, _coupled_post, _coupled_pre, default_coupled_inputs

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")


def _scaled(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _carry_on_card(fidelity, **variant):
    pem = CoupledPEM(model_fidelity=fidelity, duration=2e-5, device="cuda")
    cfg = dataclasses.replace(pem.cfg, average_start_time=0.0, **variant)
    x = default_coupled_inputs(8, torch.Generator().manual_seed(1), spread=0.08, device="cuda")
    params, _ = _coupled_pre(x, cfg)
    return pem, cfg, params, fs.init_carry(params, pem.base_B, cfg)


@pytest.mark.parametrize("fidelity,variant", [
    pytest.param((0, 0), {}, id="fidelity0"), pytest.param((2, 2), {}, id="fidelity1"),
    pytest.param((2, 2), {"num_save": 1000}, id="trace"),
    pytest.param((2, 2), {"neutral_groups": 2}, id="two_group"),
])
def test_kernel_matches_plain_on_card(fidelity, variant):
    _need_card()
    _, cfg, _, (consts, state, prof, sacc) = _carry_on_card(fidelity, **variant)
    got = [t.clone() for t in (state, prof, sacc)]
    ref = [t.clone() for t in (state, prof, sacc)]
    before = _kernels.launch_counts["kstep"]
    fs.kstep(*got, consts, 0, 50, cfg)
    fs.kstep_plain(*ref, consts, 0, 50, cfg)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["kstep"] == before + 1
    for j in range(state.shape[0]):
        assert _scaled(got[0][j], ref[0][j]) < 1e-4
    for j in range(prof.shape[0]):
        assert _scaled(got[1][j], ref[1][j]) < 1e-4
    slots = list(range(8)) + (list(range(fs.A_TRACE0, fs.A_TRACE0 + 50)) if cfg.num_save else [])
    for j in slots:
        assert _scaled(got[2][:, j], ref[2][:, j]) < 1e-4


@pytest.mark.parametrize("fidelity,groups", [((0, 0), 1), ((2, 2), 1), ((2, 2), 2)])
def test_step_kernel_matches_plain_on_card(fidelity, groups):
    _need_card()
    _, cfg, _, (consts, state, _, sacc) = _carry_on_card(fidelity, neutral_groups=groups)
    consts["scalars"][:, fs.P_ICIR] = sacc[:, fs.A_ICIR]
    extras = torch.zeros((5,) + state.shape[1:], device="cuda")
    got, got_ex, ref, ref_ex = state.clone(), extras.clone(), state.clone(), extras.clone()
    before = _kernels.launch_counts["step"]
    fs.step(got, got_ex, consts, cfg)
    fs.step_plain(ref, ref_ex, consts, cfg)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["step"] == before + 1
    for j in range(state.shape[0]):
        assert _scaled(got[j], ref[j]) < 1e-4
    for j in range(5):
        assert _scaled(got_ex[j], ref_ex[j]) < 1e-4


def test_one_step_driver_kernel_vs_plain_on_card():
    _need_card()
    pem, cfg, params, _ = _carry_on_card((2, 2))
    cfg = dataclasses.replace(cfg, duration=200 * cfg.dt, average_start_time=100 * cfg.dt)
    before = _kernels.launch_counts["step"]
    got = simulate_batch_step(params, pem.base_B, cfg)
    ref = simulate_batch_step(params, pem.base_B, cfg, block=fs.step_plain)
    assert _kernels.launch_counts["step"] == before + cfg.num_steps
    assert torch.equal(torch.isfinite(got["thrust"]), torch.isfinite(ref["thrust"]))
    for k in ("thrust", "discharge_current", "ion_current"):
        assert float(((got[k] - ref[k]).abs() / ref[k].abs()).max()) < 1e-2, k


def test_coupled_pem_kernel_vs_plain_on_card():
    _need_card()
    pem = CoupledPEM(model_fidelity=(2, 2), duration=2e-6, device="cuda")
    x = default_coupled_inputs(8, torch.Generator().manual_seed(3), spread=0.08, device="cuda")
    got = pem(x)
    sp, v_cc = _coupled_pre(x, pem.cfg)
    ref = _coupled_post(x, v_cc, fs.simulate_batch_multi(sp, pem.base_B, pem.cfg, block=fs.kstep_plain),
                        pem.sweep_radius, pem.cfg)
    assert torch.equal(torch.isfinite(got["T"]), torch.isfinite(ref["T"]))
    for k in ("T", "I_d", "I_B0"):
        assert float(((got[k] - ref[k]).abs() / ref[k].abs()).max()) < 1e-2, k


@pytest.mark.parametrize("ncharge,groups", [(1, 1), (3, 1), (3, 2)])
def test_kstep_holds_four_blocks_per_sm(ncharge, groups):
    """The K-step kernel's launch bounds leave room for four blocks on an SM,
    the occupancy its design is timed at: at fidelity (2,2) blocks of 224
    threads (202 lanes of cells and ghosts in 7 warps)."""
    _need_card()
    cfg = CoupledPEM(model_fidelity=(2, 2), duration=1e-6, device="cuda").cfg
    cfg = dataclasses.replace(cfg, ncharge=ncharge, neutral_groups=groups)
    assert fs.lanes_for(cfg) == 224
    assert _kernels.kstep_blocks_per_sm(cfg) >= 4


@pytest.mark.parametrize("variant", [{}, {"num_save": 1000}], ids=["plain", "trace"])
def test_kstep_224_lanes_match_256_bit_for_bit_on_card(variant):
    """Fidelity (2,2) on its 224 lanes and forced onto 256 from the same state
    (the instance bounded at 224 threads against the one bounded at 256): every
    state array and profile sum on lanes 0..NC-1 and every accumulator slot
    equal bit for bit after one K = 50 launch."""
    _need_card()
    _, cfg, _, (consts, state, prof, sacc) = _carry_on_card((2, 2), **variant)
    NC = cfg.nc
    widen = lambda x: torch.nn.functional.pad(x, (0, 256 - x.shape[-1])).contiguous()
    wide_consts = dict(consts, nu_anom=widen(consts["nu_anom"]), omega_ce=widen(consts["omega_ce"]))
    narrow = [t.clone() for t in (state, prof, sacc)]
    wide = [widen(state), widen(prof), sacc.clone()]
    assert narrow[0].shape[2] == 224
    _kernels.kstep_cuda(*narrow, consts, 0, 50, cfg)
    _kernels.kstep_cuda(*wide, wide_consts, 0, 50, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(narrow[0]).all()
    assert torch.equal(narrow[0][..., :NC], wide[0][..., :NC])
    assert torch.equal(narrow[1][..., :NC], wide[1][..., :NC])
    assert torch.equal(narrow[2], wide[2])


def test_kernel_wrapper_checks_inputs_on_card():
    _need_card()
    pem = CoupledPEM(model_fidelity=(0, 0), duration=1e-6, device="cuda")
    x = default_coupled_inputs(2, device="cuda")
    params, _ = _coupled_pre(x, pem.cfg)
    consts, state, prof, sacc = fs.init_carry(params, pem.base_B, pem.cfg)
    with pytest.raises(ValueError):
        fs.kstep(state.double(), prof, sacc, consts, 0, 5, pem.cfg)
    with pytest.raises(ValueError):
        fs.kstep(state[:, :1], prof, sacc, consts, 0, 5, pem.cfg)
    with pytest.raises(ValueError):
        fs.kstep(state, prof.transpose(1, 2), sacc, consts, 0, 5, pem.cfg)


@pytest.mark.parametrize("dtype,fidelity", [("float32", (4, 2)), ("float64", (2, 2))])
def test_lax_solver_on_card_matches_cpu(dtype, fidelity):
    """The lax solver (302 cells in float32, 202 in float64) runs on the card it
    is given and agrees with the same code on the host CPU after 100 steps:
    1e-4 scaled in float32, 1e-10 in float64; no kernel is launched."""
    from hallthrusterpem_tpu_torch.models.thruster import dispatch_solver, solver, uses_lax_solver

    _need_card()
    pem = CoupledPEM(model_fidelity=fidelity, duration=2e-5, device="cuda")
    cfg = dataclasses.replace(pem.cfg, average_start_time=0.0, duration=100 * pem.cfg.dt, dtype=dtype)
    assert uses_lax_solver(cfg)
    x = default_coupled_inputs(8, torch.Generator().manual_seed(2), spread=0.08, device="cuda")
    params, _ = _coupled_pre(x, cfg)
    before = dict(_kernels.launch_counts)
    got = dispatch_solver(params, pem.base_B, cfg)
    assert _kernels.launch_counts == before
    assert got["thrust"].device.type == "cuda" and got["thrust"].dtype == getattr(torch, dtype)
    ref = solver.simulate_batch({k: v.cpu() for k, v in params.items()}, pem.base_B.cpu(), cfg)
    tol = {"float32": 1e-4, "float64": 1e-10}[dtype]
    for k in ("thrust", "discharge_current", "ion_current", "ui", "Tev", "ne", "E"):
        assert _scaled(got[k].cpu(), ref[k]) < tol, k


def _lax_on_card(B, steps, dtype="float32", bad_row=False):
    from hallthrusterpem_tpu_torch.models.thruster import solver

    pem = CoupledPEM(model_fidelity=(2, 2), duration=2e-5, device="cuda")
    cfg = dataclasses.replace(pem.cfg, dtype=dtype, duration=steps * pem.cfg.dt,
                              average_start_time=steps * pem.cfg.dt / 2)
    x = default_coupled_inputs(B, torch.Generator().manual_seed(5), spread=0.08, device="cuda")
    params, _ = _coupled_pre(x, cfg)
    if bad_row:
        params = dict(params, V_d=params["V_d"].clone())
        params["V_d"][1] = 3e9
    return solver, cfg, params, pem.base_B


def _same_bits(a, b) -> bool:
    if a.is_floating_point():
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lax_graph_equals_eager_on_card(dtype):
    """``_segment_batch`` on the card replays CUDA graphs; its carry equals the
    eager route's (the same operators in the same order) bit for bit."""
    _need_card()
    solver, cfg, params, base_B = _lax_on_card(8, 200, dtype)
    carry = solver._init_batch(params, base_B, cfg)
    graph = solver._segment_batch(params, base_B, carry, cfg, 200)
    eager = solver._segment_batch_eager(params, base_B, carry, cfg, 200)
    assert int(graph[2]) == int(eager[2]) == 200
    assert all(_same_bits(g, e) for g, e in zip(solver._leaves(graph), solver._leaves(eager)))


def test_lax_graph_tail_does_not_overshoot():
    """``num_steps % GRAPH_STEPS != 0``: a graph of the remainder runs, the
    step index ends at exactly ``num_steps`` and the carry equals the eager one."""
    _need_card()
    from hallthrusterpem_tpu_torch.models.thruster.solver import GRAPH_STEPS

    n = 2 * GRAPH_STEPS + 37
    solver, cfg, params, base_B = _lax_on_card(4, n)
    carry = solver._init_batch(params, base_B, cfg)
    replay = solver._Replay(solver._traced(solver.make_step(params, base_B, cfg)[0], cfg), carry)
    replay.advance(n)
    assert sorted(replay._graphs) == [37, solver.GRAPH_STEPS] and int(replay.carry[2]) == n
    eager = solver._segment_batch_eager(params, base_B, carry, cfg, n)
    assert all(_same_bits(g, e) for g, e in zip(solver._leaves(replay.carry), solver._leaves(eager)))


def test_lax_graph_failed_row_stays_nan():
    """A blow-up row (a 3e9 V discharge) is flagged and comes back NaN through
    the graphs, with its trace, as through the eager route; the other rows stay
    finite and the traces equal bit for bit."""
    _need_card()
    solver, cfg, params, base_B = _lax_on_card(4, 300, bad_row=True)
    cfg = dataclasses.replace(cfg, num_save=32)
    out = solver.simulate_batch(params, base_B, cfg)
    trace = torch.zeros((4, 33), device="cuda")
    eager = solver._segment_batch_eager(params, base_B, solver._init_batch(params, base_B, cfg), cfg,
                                        cfg.num_steps, trace)
    assert eager[3].tolist() == [False, True, False, False]
    assert torch.isnan(out["thrust"]).tolist() == [False, True, False, False]
    assert torch.isnan(out["discharge_current_trace"][1]).all()
    assert _same_bits(out["discharge_current_trace"], torch.where(eager[3][:, None], torch.nan, trace[:, :32]))


def test_system_predict_launches_kstep():
    """``System.predict`` on the pem_v0 SPT-100 configuration runs Cathode ->
    Thruster -> Plume on the card, the Thruster through the K-step kernel."""
    from hallthrusterpem_tpu_torch.core.json_loader import load_system

    _need_card()
    system = load_system("pem_v0_SPT-100.json", device="cuda")
    comp = system["Thruster"]
    comp.model_kwargs["simulation"] = dict(comp.model_kwargs["simulation"], duration=2e-6)
    samples = system.sample_inputs(16, generator=torch.Generator().manual_seed(3))
    before = _kernels.launch_counts["kstep"]
    out = system.predict(samples, use_model="best")
    assert _kernels.launch_counts["kstep"] > before
    assert out["T"].device.type == "cuda" and out["j_ion"].shape == (16, 91)


@pytest.mark.parametrize("case", ["float32", "float64", "mixed"])
@pytest.mark.parametrize("rows", [23, 1024, 1472])
def test_plume_kernel_matches_plain_on_card(case, rows):
    """``current_density`` on the card, with ``T`` and the special rows (the
    Thruster's masked rows among them), is one launch of the plume's kernel,
    within the emulated test's tolerances of the eager plain version on the same
    card tensors, ``T_c`` of its type, every row counted as the kernel's. In
    ``mixed``, I_B0 and T are float64 beside float32 inputs, as the Thruster
    gives them once a row is masked."""
    from test_torch_plume_emulated import _assert_close, _rows

    _need_card()
    x = _rows(rows, torch.float64 if case == "float64" else torch.float32, seed=rows)
    if case == "mixed":
        x.update({k: x[k].double() for k in ("I_B0", "T")})
    x = {k: v.cuda() for k, v in x.items()}
    plume.current_density(x)  # the build, the grid on this card
    before, eager_before = plume.launch_counts["plume"], tracing.counts["plume_eager_rows"]
    kernel_before = tracing.counts["plume_kernel_rows"]
    got = plume.current_density(x)
    assert plume.launch_counts["plume"] == before + 1
    assert tracing.counts["plume_kernel_rows"] == kernel_before + rows
    assert tracing.counts["plume_eager_rows"] == eager_before
    ref = plume.current_density_plain(x)
    torch.cuda.synchronize()
    assert got["j_ion"].device.type == "cuda" and got["j_ion_coords"].shape == (rows, 91)
    assert got["T_c"].dtype == ref["T_c"].dtype == (torch.float32 if case == "float32" else torch.float64)
    _assert_close({k: v.cpu() for k, v in got.items()}, {k: v.cpu() for k, v in ref.items()})


def test_plume_on_card_launches_nothing_else():
    """A ``System.predict`` call on the card under ``torch.profiler``: inside
    ``htpem.call_model.Plume`` no operator but allocations and views, and the
    plume's kernel on the card's timeline once; every row through the kernel."""
    from torch.profiler import ProfilerActivity, profile

    from hallthrusterpem_tpu_torch.core.json_loader import load_system

    _need_card()
    system = load_system("pem_v0_SPT-100.json", device="cuda")
    comp = system["Thruster"]
    comp.model_kwargs["simulation"] = dict(comp.model_kwargs["simulation"], duration=2e-6)
    samples = system.sample_inputs(23, generator=torch.Generator().manual_seed(5))
    system.predict(samples, use_model="best")
    tracing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        system.predict(samples, use_model="best")
    assert tracing.counts["plume_kernel_rows"] == 23 and tracing.counts["plume_eager_rows"] == 0
    events = prof.profiler.kineto_results.events()
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in events if e.device_type().name == "CPU"]
    (a, b), = [(s, t) for n, s, t in host if n == "htpem.call_model.Plume"]
    inside = {n for n, s, t in host if n.startswith("aten::") and a <= s and t <= b}
    allowed = {"aten::empty", "aten::empty_strided", "aten::to", "aten::expand", "aten::broadcast_to",
               "aten::reshape", "aten::view", "aten::_reshape_alias", "aten::as_strided", "aten::select",
               "aten::alias", "aten::detach", "aten::lift_fresh"}
    assert inside <= allowed, inside - allowed
    on_card = [e.name() for e in events if e.device_type().name != "CPU" and "plume_kernel" in e.name()]
    assert len(on_card) == 1, on_card


def test_system_predict_blocks_the_host_inside_its_wait_spans():
    """Under ``torch.profiler`` on the card, a ``System.predict`` call of the
    pem_v0 SPT-100 system spends at least 99% of its host time in the CUDA
    runtime's synchronising calls inside the program's ``htpem.wait.*`` spans,
    its launch loop lies inside the solve, and no span of the program is put on
    the card's timeline, where it would count as busy time."""
    from torch.profiler import ProfilerActivity, profile

    from hallthrusterpem_tpu_torch.core.json_loader import load_system

    _need_card()
    system = load_system("pem_v0_SPT-100.json", device="cuda")
    comp = system["Thruster"]
    comp.model_kwargs["simulation"] = dict(comp.model_kwargs["simulation"], duration=2e-5)
    samples = system.sample_inputs(16, generator=torch.Generator().manual_seed(3))
    system.predict(samples, use_model="best")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        system.predict(samples, use_model="best")
    events = prof.profiler.kineto_results.events()
    assert not [e.name() for e in events if e.name().startswith("htpem.") and e.device_type().name != "CPU"]
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in events if e.device_type().name == "CPU"]
    spans = {n: (s, t) for n, s, t in host if n in ("htpem.thruster.solve", "htpem.thruster.launches")}
    assert spans["htpem.thruster.solve"][0] <= spans["htpem.thruster.launches"][0]
    assert spans["htpem.thruster.launches"][1] <= spans["htpem.thruster.solve"][1]
    waits = [(s, t) for n, s, t in host if n.startswith("htpem.wait.")]
    blocked = [(s, t) for n, s, t in host if n in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]
    inside = sum(t - s for s, t in blocked if any(a <= s and t <= b for a, b in waits))
    assert inside >= 0.99 * sum(t - s for s, t in blocked) > 0


def test_mlp_forward_on_card_matches_cpu():
    """The r5 width (21 inputs, 4 x 512, 8 members, 36 outputs) on random
    weights, 4096 rows: the card within 1e-5 of the CPU's scale; with TF32
    switched on around the call the forward still runs in full float32 (the same
    numbers bit for bit)."""
    import numpy as np

    from hallthrusterpem_tpu_torch.surrogate.mlp import EnsembleMLP, full_fp32

    _need_card()
    rng = np.random.default_rng(0)
    sizes = [21, 512, 512, 512, 512, 36]
    params = [((rng.standard_normal((8, a, b)) * np.sqrt(2 / a)).astype(np.float32),
               (0.1 * rng.standard_normal((8, 1, b))).astype(np.float32)) for a, b in zip(sizes[:-1], sizes[1:])]
    x = torch.as_tensor(rng.standard_normal((4096, 21)).astype(np.float32))
    cpu, card = EnsembleMLP(params), EnsembleMLP(params).cuda()
    with torch.no_grad(), full_fp32():
        ref, got = cpu(x), card(x.cuda())
    assert _scaled(got.cpu(), ref) < 1e-5
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with torch.no_grad(), full_fp32():
            again = card(x.cuda())
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved)
    assert torch.equal(again, got)


@pytest.mark.parametrize("method", ["lagrange", "linear"])
def test_eval_tensor_on_card_matches_cpu(method):
    """``eval_tensor`` on the card against the CPU: four dims, 10,000 points,
    float64 within 1e-12 and float32 within 1e-5 of the values' scale."""
    import numpy as np

    from hallthrusterpem_tpu_torch.surrogate import TensorInterpolant, eval_tensor, knots_for_level

    _need_card()
    knots = [knots_for_level(lv, 2, (-1.0, 1.0)) for lv in (2, 1, 3, 0)]
    rng = np.random.default_rng(1)
    ti = TensorInterpolant(knots=knots, values=rng.standard_normal((5, 3, 7, 1, 6)), method=method)
    xq = rng.uniform(-1.1, 1.1, (10_000, 4))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        args = lambda dev: ([torch.as_tensor(k, dtype=dtype, device=dev) for k in ti.knots],
                            [torch.as_tensor(w, dtype=dtype, device=dev) for w in ti._weights],
                            torch.as_tensor(ti.values, dtype=dtype, device=dev),
                            torch.as_tensor(xq, dtype=dtype, device=dev))
        ref = eval_tensor(*args("cpu"), method=method)
        got = eval_tensor(*args("cuda"), method=method)
        assert got.dtype == dtype and _scaled(got.cpu(), ref) < tol, dtype


def _posterior_systems():
    """``pem_v0_SPT-100_compression.json`` on the CPU and on the card with one
    small MLP surrogate (2 x 32, 2 members, 40 steps) trained on the CPU on
    smooth synthetic labels of its outputs (u_ion and j_ion through their
    compression maps), and the posterior's arguments: the spt100 data with
    every QoI, M = 4 noise samples."""
    import argparse

    import numpy as np

    from hallthrusterpem_tpu_torch.core.dataset import as_numpy
    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.surrogate.mlp import MLPSurrogate

    cpu = load_system("pem_v0_SPT-100_compression.json", device="cpu")
    x = as_numpy(cpu.sample_inputs(256, seed=0, use_pdf=["calibration", "nuisance"]))
    z = np.stack([cpu._variables[k].normalize(x[k]) for k in sorted(x)], -1)
    z = (z - z.mean(0)) / z.std(0)
    smooth = np.tanh(z @ np.random.default_rng(0).standard_normal((z.shape[1], 8)) / 4)
    outputs = {}
    for i, var in enumerate(cpu.outputs()):
        if var.compression is not None:
            lat = 0.05 * smooth[:, np.arange(var.compression.latent_size) % 8]
            outputs[var.name] = var.denormalize(var.compression.reconstruct(lat))
        else:
            outputs[var.name] = (var.nominal or 1.0) * (1 + 0.1 * smooth[:, i % 8])
    surr = MLPSurrogate(cpu, hidden=(32, 32), ensemble=2, seed=0)
    surr.fit(x, outputs, steps=40, batch=64, verbose=False)
    cpu.system_surrogate = surr
    card = load_system("pem_v0_SPT-100_compression.json", device="cuda")
    card.system_surrogate = MLPSurrogate.from_state(surr.to_state(), card)
    args = argparse.Namespace(data=["spt100"], qois=["V_cc", "T", "I_d", "u_ion", "j_ion"], noise_samples=4,
                              field_weight=1.0, id_penalty=2.0, use_model=None)
    return cpu, card, args


def _posterior(system, args, **kw):
    import numpy as np

    from hallthrusterpem_tpu_torch.scripts.pem_v0 import mcmc

    calib = [v for v in system.inputs() if v.category == "calibration"]
    ops, obs, sig, fields = mcmc.build_dataset(system, args)
    wrapper, fn = mcmc.build_device_posterior(system, args, calib, [v.name for v in calib], ops, obs, sig, fields,
                                              **kw)
    dom = np.array([v.get_domain() for v in calib])
    thetas = lambda W, seed: dom[:, 0] + np.random.default_rng(seed).uniform(0.1, 0.9, (W, len(calib))) * (
        dom[:, 1] - dom[:, 0])
    return wrapper, fn, thetas


def test_device_posterior_on_card_matches_cpu():
    """The pem_v0 device posterior (``scripts/pem_v0/mcmc.build_device_posterior``)
    on the card against the same function on the CPU (:func:`_posterior_systems`),
    32 thetas over the priors: each value within 1e-4 of its own; the result
    stays on the card until the numpy wrapper reads it."""
    import numpy as np

    _need_card()
    cpu, card, args = _posterior_systems()
    lps = []
    for system in (cpu, card):
        wrapper, fn, thetas = _posterior(system, args)
        theta = thetas(32, 1)
        out = fn(torch.as_tensor(theta, dtype=torch.float32, device=system.device))
        assert out.device.type == system.device.type and out.shape == (32,)
        lps.append(wrapper(theta))
    ref, got = lps
    assert np.all(np.abs(ref) < 1e29), ref
    assert np.all(np.abs(got - ref) <= 1e-4 * np.abs(ref)), (got, ref)


def test_device_posterior_graphs_equal_eager_on_card():
    """On the card the posterior replays one CUDA graph per walker count; at 8,
    32 and 64 walkers, called in turns with new thetas, it equals the eager
    route (``graphs=False``) bit for bit, and each torch call returns its own
    tensor."""
    import numpy as np

    _need_card()
    _, card, args = _posterior_systems()
    graphed, graphed_fn, thetas = _posterior(card, args)
    eager, _, _ = _posterior(card, args, graphs=False)
    kept = []
    for rep in range(2):
        for W in (8, 32, 64):
            theta = thetas(W, 10 * rep + W)
            np.testing.assert_array_equal(graphed(theta), eager(theta))
            kept.append((graphed_fn(torch.as_tensor(theta, dtype=torch.float32, device="cuda")), eager(theta)))
    for out, ref in kept:
        np.testing.assert_array_equal(out.cpu().numpy().astype(float), ref)


def _one_step_on_card(batch, n_steps, bad_row=False):
    pem, cfg, params, _ = _carry_on_card((2, 2))
    cfg = dataclasses.replace(cfg, duration=n_steps * cfg.dt, average_start_time=(n_steps // 2) * cfg.dt)
    params = {k: v[:batch].clone() for k, v in params.items()}
    if bad_row:  # a huge voltage and a starved flow: the row runs away
        params["V_d"][1], params["mdot_a"][1] = 3e7, 1e-9
    return pem, cfg, params


def test_one_step_graphs_equal_eager_on_card():
    """The one-step driver on the card replays CUDA graphs; its outputs equal
    its eager route (``graphs=False``) bit for bit, a runaway row included, and
    both launch the step kernel ``num_steps`` times."""
    _need_card()
    from hallthrusterpem_tpu_torch.models.thruster.one_step import GRAPH_STEPS

    pem, cfg, params = _one_step_on_card(8, 2 * GRAPH_STEPS + 38, bad_row=True)
    out = {}
    for graphs in (True, False):
        before = _kernels.launch_counts["step"]
        out[graphs] = simulate_batch_step(params, pem.base_B, cfg, graphs=graphs)
        torch.cuda.synchronize()
        assert _kernels.launch_counts["step"] == before + cfg.num_steps, graphs
    assert all(_same_bits(out[True][k], out[False][k]) for k in out[False])


def test_one_step_graph_tail_does_not_overshoot():
    """``num_steps - 1`` not a multiple of ``GRAPH_STEPS``, and chunked: after
    the eager first step a graph of ``GRAPH_STEPS`` steps and one of the
    remainder are captured, so that exactly the steps asked for run (with
    ``chunk_steps`` the chunked count); the outputs equal the eager route's."""
    _need_card()
    from hallthrusterpem_tpu_torch import cuda_graph
    from hallthrusterpem_tpu_torch.models.thruster import one_step

    pem, cfg, params = _one_step_on_card(4, one_step.GRAPH_STEPS + 41)
    real, sizes = cuda_graph.capture, []

    def recording(body, device, warmup=None):
        g = real(body, device, warmup)
        sizes.append(g.launches.get("step", 0))
        return g

    for chunk, n in ((0, cfg.num_steps), (60, 180)):
        sizes.clear()
        cuda_graph.capture = recording
        try:
            before = _kernels.launch_counts["step"]
            got = simulate_batch_step(params, pem.base_B, cfg, chunk_steps=chunk)
        finally:
            cuda_graph.capture = real
        assert _kernels.launch_counts["step"] == before + n, chunk
        assert sizes == [one_step.GRAPH_STEPS, (n - 1) % one_step.GRAPH_STEPS], (chunk, sizes)
        eager = simulate_batch_step(params, pem.base_B, cfg, chunk_steps=chunk, graphs=False)
        assert all(_same_bits(got[k], eager[k]) for k in eager), chunk


def test_launch_counter_across_replays():
    """A launch made under a capture is counted at each replay of its graph, not
    at the capture: three replays of a graph of five step launches add 15."""
    _need_card()
    from hallthrusterpem_tpu_torch import cuda_graph

    _, cfg, _, (consts, state, _, sacc) = _carry_on_card((2, 2))
    consts["scalars"][:, fs.P_ICIR] = sacc[:, fs.A_ICIR]
    extras = torch.zeros((5,) + state.shape[1:], device="cuda")
    fs.step(state, extras, consts, cfg)  # warm: the rate coefficients reach the card
    before = _kernels.launch_counts["step"]
    graph = cuda_graph.capture(lambda: [fs.step(state, extras, consts, cfg) for _ in range(5)], state.device)
    assert graph.launches == {"step": 5} and _kernels.launch_counts["step"] == before
    for k in range(1, 4):
        graph.replay()
        assert _kernels.launch_counts["step"] == before + 5 * k
    torch.cuda.synchronize()
    assert bool(torch.isfinite(state).all())


def _main_path_on_card(batch=64, duration=2e-6):
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=duration, device="cuda")
    x = default_coupled_inputs(batch, torch.Generator().manual_seed(4), spread=0.08, device="cuda")
    return pem, x, pem(x)


def _bit_equal(got: dict, ref: dict) -> list:
    """The outputs of ``got`` that differ from ``ref`` in any bit (NaN rows alike)."""
    import numpy as np

    assert set(got) == set(ref)
    return [k for k in ref if got[k].dtype != ref[k].dtype
            or not np.array_equal(got[k].cpu().numpy(), ref[k].cpu().numpy(), equal_nan=True)]


def test_batch_executor_every_card_bit_equal():
    """``BatchExecutor(make_mesh())`` over every card of the machine runs the
    coupled PEM with the outputs of the unsharded run, bit for bit, and one
    ``kstep`` launch per card and block of steps."""
    import math

    from hallthrusterpem_tpu_torch.parallel import BatchExecutor, make_mesh

    _need_card()
    pem, x, ref = _main_path_on_card()
    mesh = make_mesh()
    before = _kernels.launch_counts["kstep"]
    got = BatchExecutor(mesh).run(pem, x)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["kstep"] == before + mesh.n_devices * math.ceil(pem.cfg.num_steps / 50)
    assert got["T"].device == mesh.devices[0]
    assert not _bit_equal(got, ref)


def test_two_shards_on_one_card_bit_equal():
    """``simulate_batch_sharded`` on ``Mesh([cuda:0, cuda:0])``: two shards run in
    turn on one card, twice the launches, the unsharded run's bits."""
    import math

    from hallthrusterpem_tpu_torch.models.thruster import simulate_batch_sharded
    from hallthrusterpem_tpu_torch.parallel import Mesh

    _need_card()
    pem, x, ref = _main_path_on_card()
    params, v_cc = _coupled_pre(x, pem.cfg)
    before = _kernels.launch_counts["kstep"]
    sol = simulate_batch_sharded(params, pem.base_B, pem.cfg, Mesh([torch.device("cuda", 0)] * 2))
    torch.cuda.synchronize()
    assert _kernels.launch_counts["kstep"] == before + 2 * math.ceil(pem.cfg.num_steps / 50)
    assert not _bit_equal(_coupled_post(x, v_cc, sol, pem.sweep_radius, pem.cfg), ref)
