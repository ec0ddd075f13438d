"""The K-step and one-step CUDA kernels on the card against their plain PyTorch
versions; the lax solver on the card against the host CPU; the System path; the
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
    """The K-step kernel's launch bounds leave room for four 256-thread blocks
    on an SM, the occupancy its design is timed at."""
    _need_card()
    cfg = CoupledPEM(model_fidelity=(2, 2), duration=1e-6, device="cuda").cfg
    cfg = dataclasses.replace(cfg, ncharge=ncharge, neutral_groups=groups)
    assert fs.lanes_for(cfg) == 256
    assert _kernels.kstep_blocks_per_sm(cfg) >= 4


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


def test_device_posterior_on_card_matches_cpu():
    """The pem_v0 device posterior (``scripts/pem_v0/mcmc.build_device_posterior``)
    on the card against the same function on the CPU: a small MLP surrogate
    (2 x 32, 2 members, 40 steps) trained on the CPU on smooth synthetic labels
    of ``pem_v0_SPT-100_compression.json``'s outputs (u_ion and j_ion through
    their compression maps), the spt100 data with every QoI, M = 4 noise
    samples, 32 thetas over the priors: each value within 1e-4 of its own; the result
    stays on the card until the numpy wrapper reads it."""
    import argparse

    import numpy as np

    from hallthrusterpem_tpu_torch.core.dataset import as_numpy
    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.scripts.pem_v0 import mcmc
    from hallthrusterpem_tpu_torch.surrogate.mlp import MLPSurrogate

    _need_card()
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
    lps = []
    for system in (cpu, card):
        calib = [v for v in system.inputs() if v.category == "calibration"]
        ops, obs, sig, fields = mcmc.build_dataset(system, args)
        wrapper, fn = mcmc.build_device_posterior(system, args, calib, [v.name for v in calib], ops, obs, sig,
                                                  fields)
        dom = np.array([v.get_domain() for v in calib])
        u = np.random.default_rng(1).uniform(0.1, 0.9, (32, len(calib)))
        theta = dom[:, 0] + u * (dom[:, 1] - dom[:, 0])
        out = fn(torch.as_tensor(theta, dtype=torch.float32, device=system.device))
        assert out.device.type == system.device.type and out.shape == (32,)
        lps.append(wrapper(theta))
    ref, got = lps
    assert np.all(np.abs(ref) < 1e29), ref
    assert np.all(np.abs(got - ref) <= 1e-4 * np.abs(ref)), (got, ref)


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
