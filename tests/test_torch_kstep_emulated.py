"""The CUDA source of the K-step kernel, compiled with g++ against a CPU
emulation of the CUDA thread model (tests/cuda_cpu_emulation), against its plain
PyTorch version. This checks the kernel's arithmetic, its shared-memory staging
and its barriers on a machine without a GPU; the build and the run on the card
are checked by the `gpu` tests and chip_smoke.py.

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
LAUNCH = re.compile(r"kstep_kernel<Z><<<B, LN, 0, s>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is needed to compile the kernel source for the CPU")
    src = _kernels.SOURCE.read_text()
    assert LAUNCH.search(src), "kernel launch not found in kstep.cu"
    src = LAUNCH.sub(lambda m: "emu_launch(B, LN, [&] { kstep_kernel<Z>(" + m.group(1) + "); });", src)
    out = tmp_path_factory.mktemp("kstep_emu")
    (out / "kstep_emu.cpp").write_text(src)
    lib_path = out / "libkstep_emu.so"
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                           "-pthread", f"-I{EMU}", "-o", str(lib_path), str(out / "kstep_emu.cpp")],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    lib.kstep_params_size.restype = ctypes.c_int
    lib.kstep_launch.restype = ctypes.c_int
    lib.kstep_launch.argtypes = [ctypes.POINTER(_kernels.KParams)] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
    return lib


def test_struct_layout_matches(emulated):
    assert emulated.kstep_params_size() == ctypes.sizeof(_kernels.KParams)


@pytest.mark.parametrize("ncharge,num_cells,K,i0,plume", [
    (1, 60, 12, 1244, True),     # 128 lanes, crosses the start of the averaging window
    (2, 60, 9, 1245, False),     # no plume cone
    (3, 200, 6, 2497, True),     # full width: 256 lanes, overshoots the last step
])
def test_emulated_kernel_matches_plain(emulated, ncharge, num_cells, K, i0, plume):
    nsteps = 2500
    cfg = SolverConfig(num_cells=num_cells, ncharge=ncharge, dt=8e-9, duration=nsteps * 8e-9,
                       average_start_time=nsteps // 2 * 8e-9, solve_plume=plume,
                       apply_thrust_divergence_correction=plume)
    B = 3
    z = cfg.cell_centers()
    s = np.where(z < 0.025, 0.011, 0.018)
    base_B = torch.tensor(0.016 * np.exp(-0.5 * ((z - 0.025) / s) ** 2), dtype=torch.float32)
    params = make_params({"V_d": torch.linspace(285, 315, B), "V_cc": 30.0, "mdot_a": 5e-6,
                          "P_b": 1e-5}, device="cpu")
    consts, state, prof, sacc = fs.init_carry(params, base_B, cfg)
    fs.kstep_plain(state, prof, sacc, consts, 0, 20, cfg)  # leave the smooth initial state
    state[2, 1, 7] = float("nan")  # one poisoned sample: the scrub and the failed flag

    ref = [x.clone() for x in (state, prof, sacc)]
    fs.kstep_plain(*ref, consts, i0, K, cfg)
    got = [x.clone() for x in (state, prof, sacc)]
    p = _kernels.kernel_params(cfg)
    p.i0, p.K = i0, K
    coef = torch.as_tensor(_kernels.rate_coefficients(cfg))
    rc = emulated.kstep_launch(ctypes.byref(p), ncharge, B, fs.lanes_for(cfg), *(x.data_ptr() for x in got),
                               consts["nu_anom"].data_ptr(), consts["omega_ce"].data_ptr(),
                               consts["scalars"].data_ptr(), coef.data_ptr(), None)
    assert rc == 0
    pairs = [(got[0][j], ref[0][j]) for j in range(state.shape[0])]
    pairs += [(got[1][j], ref[1][j]) for j in range(prof.shape[0])]
    pairs += [(got[2][:, j], ref[2][:, j]) for j in range(8)]
    for g, r in pairs:
        assert torch.isfinite(g).all()
        assert float((g - r).abs().max() / r.abs().max().clamp_min(1e-30)) < 1e-5
    assert got[2][1, fs.A_FAILED] == 1.0 and got[2][0, fs.A_FAILED] == 0.0
