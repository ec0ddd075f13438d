"""The CUDA sources of the discharge kernels (the K-step kernel ``kstep.cu`` and the
one-step kernel ``step.cu``, which share ``physics.cuh``), compiled with g++
against a CPU emulation of the CUDA thread model (tests/cuda_cpu_emulation),
against their plain PyTorch versions. This checks the kernels' arithmetic, their
shared-memory staging and their barriers on a machine without a GPU; the build
and the run on the card are checked by the `gpu` tests and chip_smoke.py.

Tolerance: scaled error (max |kernel - plain| / max |plain| per array) below
1e-5; both round every float32 operation alike, only the reduction order
differs."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hallthrusterpem_tpu_torch.models.thruster import _kernels
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig, make_params

EMU = Path(__file__).parent / "cuda_cpu_emulation"
LAUNCH = re.compile(r"(\w+_kernel<Z, G>)<<<B, LN, 0, s>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is needed to compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("kernels_emu")
    libs, procs = {}, {}
    for name, src_path in _kernels.SOURCES.items():
        src = src_path.read_text()
        assert LAUNCH.search(src), f"kernel launch not found in {src_path.name}"
        src = LAUNCH.sub(lambda m: f"emu_launch(B, LN, [&] {{ {m.group(1)}({m.group(2)}); }});", src)
        cpp = out / f"{name}_emu.cpp"
        cpp.write_text(src)
        lib_path = out / f"lib{name}_emu.so"
        procs[name] = (lib_path, subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{EMU}",
             f"-I{_kernels.CSRC}", "-o", str(lib_path), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib_path, proc) in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log[-4000:]
        lib = ctypes.CDLL(str(lib_path))
        getattr(lib, f"{name}_params_size").restype = ctypes.c_int
        launch = getattr(lib, f"{name}_launch")
        launch.restype = ctypes.c_int
        launch.argtypes = ([ctypes.POINTER(_kernels.KParams)] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p] * (8 if name == "kstep" else 7))
        libs[name] = lib
    return libs


def test_struct_layout_matches(emulated):
    for name, lib in emulated.items():
        assert getattr(lib, f"{name}_params_size")() == ctypes.sizeof(_kernels.KParams), name


def _state_after_warmup(ncharge, num_cells, plume, groups=1, num_save=0, B=3):
    """A config and a carry 20 plain steps into a run, with one poisoned sample."""
    nsteps = 2500
    cfg = SolverConfig(num_cells=num_cells, ncharge=ncharge, dt=8e-9, duration=nsteps * 8e-9,
                       average_start_time=nsteps // 2 * 8e-9, solve_plume=plume,
                       apply_thrust_divergence_correction=plume, neutral_groups=groups,
                       num_save=num_save)
    z = cfg.cell_centers()
    s = np.where(z < 0.025, 0.011, 0.018)
    base_B = torch.tensor(0.016 * np.exp(-0.5 * ((z - 0.025) / s) ** 2), dtype=torch.float32)
    params = make_params({"V_d": torch.linspace(285, 315, B), "V_cc": 30.0, "mdot_a": 5e-6,
                          "P_b": 1e-5}, device="cpu")
    consts, state, prof, sacc = fs.init_carry(params, base_B, cfg)
    fs.kstep_plain(state, prof, sacc, consts, 0, 20, cfg)  # leave the smooth initial state
    state[2, 1, 7] = float("nan")  # one poisoned sample: the scrub and the failed flag
    return cfg, consts, state, prof, sacc


def _assert_scaled_close(pairs):
    for name, g, r in pairs:
        assert torch.isfinite(g).all(), name
        err = float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
        assert err < 1e-5, (name, err)


@pytest.mark.parametrize("ncharge,num_cells,K,i0,plume,groups,num_save", [
    # 128 lanes, crosses the start of the averaging window
    pytest.param(1, 60, 12, 1244, True, 1, 0, id="1-60-12-1244-True"),
    pytest.param(2, 60, 9, 1245, False, 1, 0, id="2-60-9-1245-False"),  # no plume cone
    # full width: 256 lanes, overshoots the last step
    pytest.param(3, 200, 6, 2497, True, 1, 0, id="3-200-6-2497-True"),
    pytest.param(1, 60, 11, 1244, True, 1, 40, id="1-60-11-1244-True-trace"),  # I_d(t) trace lanes
    pytest.param(2, 60, 7, 1245, True, 2, 0, id="2-60-7-1245-True-two_group"),  # two neutral groups
])
def test_emulated_kernel_matches_plain(emulated, ncharge, num_cells, K, i0, plume, groups, num_save):
    cfg, consts, state, prof, sacc = _state_after_warmup(ncharge, num_cells, plume, groups, num_save)
    B = state.shape[1]
    ref = [x.clone() for x in (state, prof, sacc)]
    fs.kstep_plain(*ref, consts, i0, K, cfg)
    got = [x.clone() for x in (state, prof, sacc)]
    p = _kernels.kernel_params(cfg)
    p.i0, p.K = i0, K
    coef = torch.as_tensor(_kernels.rate_coefficients(cfg))
    rc = emulated["kstep"].kstep_launch(
        ctypes.byref(p), ncharge, groups, B, fs.lanes_for(cfg), *(x.data_ptr() for x in got),
        consts["nu_anom"].data_ptr(), consts["omega_ce"].data_ptr(), consts["scalars"].data_ptr(),
        coef.data_ptr(), None)
    assert rc == 0
    slots = list(range(fs.A_ICIR + 1)) + ([fs.A_TRACE0 + k for k in range(K)] if num_save else [])
    pairs = [(f"state {j}", got[0][j], ref[0][j]) for j in range(state.shape[0])]
    pairs += [(f"prof {j}", got[1][j], ref[1][j]) for j in range(prof.shape[0])]
    pairs += [(f"sacc {j}", got[2][:, j], ref[2][:, j]) for j in slots]
    _assert_scaled_close(pairs)
    assert got[2][1, fs.A_FAILED] == 1.0 and got[2][0, fs.A_FAILED] == 0.0


@pytest.mark.parametrize("ncharge,num_cells,plume,groups", [
    (1, 60, True, 1),
    (3, 200, True, 1),    # full width: 256 lanes
    (2, 60, False, 2),    # two neutral groups, no plume cone
])
def test_emulated_step_kernel_matches_plain(emulated, ncharge, num_cells, plume, groups):
    cfg, consts, state, prof, sacc = _state_after_warmup(ncharge, num_cells, plume, groups)
    B, LN = state.shape[1], fs.lanes_for(cfg)
    consts["scalars"][:, fs.P_ICIR] = sacc[:, fs.A_ICIR]
    ref_state, ref_extras = state.clone(), torch.zeros((5, B, LN))
    fs.step_plain(ref_state, ref_extras, consts, cfg)
    got_state, got_extras = state.clone(), torch.zeros((5, B, LN))
    p = _kernels.kernel_params(cfg)
    coef = torch.as_tensor(_kernels.rate_coefficients(cfg))
    rc = emulated["step"].step_launch(
        ctypes.byref(p), ncharge, groups, B, LN, got_state.data_ptr(), got_extras.data_ptr(),
        consts["nu_anom"].data_ptr(), consts["omega_ce"].data_ptr(), consts["scalars"].data_ptr(),
        coef.data_ptr(), None)
    assert rc == 0
    pairs = [(f"state {j}", got_state[j], ref_state[j]) for j in range(state.shape[0])]
    pairs += [(f"extras {j}", got_extras[j], ref_extras[j]) for j in range(5)]
    _assert_scaled_close(pairs)
