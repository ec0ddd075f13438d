"""The K-step CUDA kernel on the card against its plain PyTorch version.

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
from hallthrusterpem_tpu_torch.pem import CoupledPEM, _coupled_post, _coupled_pre, default_coupled_inputs

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")


def _scaled(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("fidelity", [(0, 0), (2, 2)])
def test_kernel_matches_plain_on_card(fidelity):
    _need_card()
    pem = CoupledPEM(model_fidelity=fidelity, duration=2e-5, device="cuda")
    cfg = dataclasses.replace(pem.cfg, average_start_time=0.0)
    x = default_coupled_inputs(8, torch.Generator().manual_seed(1), spread=0.08, device="cuda")
    params, _ = _coupled_pre(x, cfg)
    consts, state, prof, sacc = fs.init_carry(params, pem.base_B, cfg)
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
    for j in range(8):
        assert _scaled(got[2][:, j], ref[2][:, j]) < 1e-4


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
