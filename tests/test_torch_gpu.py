"""The K-step and one-step CUDA kernels on the card against their plain PyTorch
versions.

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
