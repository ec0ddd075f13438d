"""The CUDA sources of the discharge kernels (the K-step kernel ``kstep.cu`` and the
one-step kernel ``step.cu``, which share ``physics.cuh``), compiled with g++
against a CPU emulation of the CUDA thread model (tests/cuda_cpu_emulation),
against their plain PyTorch versions. This checks the kernels' arithmetic, their
shared-memory staging and their barriers on a machine without a GPU; each block
starts with its shared memory NaN, so a read of an entry the block never wrote
shows. The build and the run on the card are checked by the `gpu` tests and
chip_smoke.py.

Tolerance: scaled error (max |kernel - plain| / max |plain| per array) below
1e-5; both round every float32 operation alike, except the reduction order and
the kernel's explicit fmaf (fused, as on the card, where the plain version
rounds the product and the sum apart)."""

import ctypes
import dataclasses
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
LAUNCH = re.compile(r"(\w+_kernel<Z, G(?:, NT)?>)<<<B, LN, 0, s>>>\((.*?)\);", re.S)
#: a __shared__ declaration, which the emulated source follows with emu_poison()
SHARED = re.compile(r"__shared__ [\w:]+ (\w+)(?:\[[^\]]*\])?;")


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
        assert SHARED.search(src), f"no __shared__ declaration in {src_path.name}"
        src = SHARED.sub(lambda m: f"{m.group(0)} emu_poison({m.group(1)});", src)
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


def _state_after_warmup(ncharge, num_cells, plume, groups=1, num_save=0, B=3, **flags):
    """A config and a carry 20 plain steps into a run, with one poisoned sample."""
    nsteps = 2500
    cfg = SolverConfig(num_cells=num_cells, ncharge=ncharge, dt=8e-9, duration=nsteps * 8e-9,
                       average_start_time=nsteps // 2 * 8e-9, solve_plume=plume,
                       apply_thrust_divergence_correction=plume, neutral_groups=groups,
                       num_save=num_save, **flags)
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
    # fidelity (2,2)'s width: 224 lanes, overshoots the last step
    pytest.param(3, 200, 6, 2497, True, 1, 0, id="3-200-6-2497-True"),
    pytest.param(1, 60, 11, 1244, True, 1, 40, id="1-60-11-1244-True-trace"),  # I_d(t) trace lanes
    pytest.param(2, 60, 7, 1245, True, 2, 0, id="2-60-7-1245-True-two_group"),  # two neutral groups
    # 224 lanes with every staging row of a set and the whole lane NC-2 broadcast in use
    pytest.param(3, 200, 6, 2497, True, 2, 40, id="3-200-6-2497-True-two_group-trace"),
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


@pytest.mark.parametrize("ncharge,num_cells,plume,reconstruct", [
    (3, 200, True, True),   # fidelity (2,2): 8 PCR levels
    (1, 60, False, False),  # 6 PCR levels, no MUSCL exchanges
])
def test_emulated_barriers_per_step(emulated, ncharge, num_cells, plume, reconstruct):
    """The block barriers a K-step launch crosses per step, counted in the
    compiled source, are what the note in physics.cuh states, 7 + n_levels with
    MUSCL reconstruction and 2 fewer without (chip_smoke.py reads the same count
    from the SASS the card runs): launches of K = 1 and K = 3 differ by two steps."""
    cfg, consts, state, prof, sacc = _state_after_warmup(ncharge, num_cells, plume)
    cfg = dataclasses.replace(cfg, reconstruct=reconstruct)
    B = state.shape[1]
    lib = emulated["kstep"]
    lib.emu_barriers.restype = ctypes.c_long
    p = _kernels.kernel_params(cfg)
    coef = torch.as_tensor(_kernels.rate_coefficients(cfg))
    counts = []
    for K in (1, 3):
        p.i0, p.K = 0, K
        carry = [x.clone() for x in (state, prof, sacc)]
        before = lib.emu_barriers()
        rc = lib.kstep_launch(
            ctypes.byref(p), ncharge, 1, B, fs.lanes_for(cfg), *(x.data_ptr() for x in carry),
            consts["nu_anom"].data_ptr(), consts["omega_ce"].data_ptr(), consts["scalars"].data_ptr(),
            coef.data_ptr(), None)
        assert rc == 0
        counts.append(lib.emu_barriers() - before)
    stated = 5 + 2 * int(reconstruct) + p.n_levels
    assert (counts[1] - counts[0]) / (2 * B) == stated  # thread 0 of each block
    assert stated <= 15


@pytest.mark.parametrize("ncharge,num_cells,plume,groups", [
    (1, 60, True, 1),
    (3, 200, True, 1),    # 224 lanes
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


#: the kernel's flag sets at fidelity (2,2): the pem_v0 SPT-100 system's, and the
#: H9-class system's (no ion wall losses, plume cone or divergence correction;
#: GaussianBohm transport under a logistic pressure shift; no circuit)
FLAG_SETS = {
    "spt100": dict(plume=True),
    "h9": dict(plume=False, ion_wall_losses=False, anom_model="GaussianBohm",
               pressure_shift="SimpleLogisticShift"),
}


def _widen(x, lanes):
    """``x`` with its lane axis (the last) padded with zeros to ``lanes``."""
    return torch.nn.functional.pad(x, (0, lanes - x.shape[-1])).contiguous()


def _kstep_emulated(lib, cfg, carry, consts, i0, K, lanes):
    p = _kernels.kernel_params(cfg)
    p.i0, p.K = i0, K
    coef = torch.as_tensor(_kernels.rate_coefficients(cfg))
    rc = lib.kstep_launch(
        ctypes.byref(p), cfg.ncharge, cfg.neutral_groups, carry[0].shape[1], lanes,
        *(x.data_ptr() for x in carry), consts["nu_anom"].data_ptr(), consts["omega_ce"].data_ptr(),
        consts["scalars"].data_ptr(), coef.data_ptr(), None)
    assert rc == 0


@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
def test_emulated_224_lanes_match_256_bit_for_bit(emulated, flags):
    """Fidelity (2,2) on 224 lanes (7 warps), the layout's width since the rule
    sizes it to the warp, against the same launch on 256 lanes from the same
    state: every state array and profile sum on lanes 0..NC-1 and every
    accumulator slot, trace lanes included, equal bit for bit, for the kernel
    and for the plain version; and the 224-lane kernel against the plain
    version within the file's tolerance. Each block starts with its shared
    memory NaN, so a staging row's tail left unzeroed shows."""
    kw = dict(FLAG_SETS[flags])
    plume = kw.pop("plume")
    cfg, consts, state, prof, sacc = _state_after_warmup(3, 200, plume, num_save=40, **kw)
    NC, K, i0 = cfg.nc, 6, 1247  # crosses the start of the averaging window
    assert fs.lanes_for(cfg) == 224 == state.shape[2]
    wide_consts = dict(consts, nu_anom=_widen(consts["nu_anom"], 256), omega_ce=_widen(consts["omega_ce"], 256))
    runs = {}
    for lanes, c in ((224, consts), (256, wide_consts)):
        kernel = [_widen(x, lanes) for x in (state, prof)] + [sacc.clone()]
        _kstep_emulated(emulated["kstep"], cfg, kernel, c, i0, K, lanes)
        plain = [_widen(x, lanes) for x in (state, prof)] + [sacc.clone()]
        fs.kstep_plain(*plain, c, i0, K, cfg)
        runs[lanes] = kernel, plain
    for route in (0, 1):
        (s1, p1, a1), (s2, p2, a2) = runs[224][route], runs[256][route]
        assert torch.equal(s1[..., :NC], s2[..., :NC]), route
        assert torch.equal(p1[..., :NC], p2[..., :NC]), route
        assert torch.equal(a1, a2), route
    (ks, kp, ka), (ps, pp, pa) = runs[224]
    slots = list(range(fs.A_ICIR + 1)) + [fs.A_TRACE0 + k for k in range(K)]
    pairs = [(f"state {j}", ks[j], ps[j]) for j in range(ks.shape[0])]
    pairs += [(f"prof {j}", kp[j], pp[j]) for j in range(kp.shape[0])]
    pairs += [(f"sacc {j}", ka[:, j], pa[:, j]) for j in slots]
    _assert_scaled_close(pairs)
    assert ka[1, fs.A_FAILED] == 1.0 and ka[0, fs.A_FAILED] == 0.0


@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
def test_emulated_step_kernel_224_lanes_match_256_bit_for_bit(emulated, flags):
    """The one-step kernel at fidelity (2,2) on 224 and on 256 lanes from the same
    state: the state and all five output arrays on lanes 0..NC-1 equal bit for
    bit; the 224-lane launch against the plain version within the tolerance."""
    kw = dict(FLAG_SETS[flags])
    plume = kw.pop("plume")
    cfg, consts, state, prof, sacc = _state_after_warmup(3, 200, plume, **kw)
    NC, B = cfg.nc, state.shape[1]
    consts["scalars"][:, fs.P_ICIR] = sacc[:, fs.A_ICIR]
    wide_consts = dict(consts, nu_anom=_widen(consts["nu_anom"], 256), omega_ce=_widen(consts["omega_ce"], 256))
    p = _kernels.kernel_params(cfg)
    coef = torch.as_tensor(_kernels.rate_coefficients(cfg))
    got = {}
    for lanes, c in ((224, consts), (256, wide_consts)):
        st, ex = _widen(state, lanes), torch.zeros((5, B, lanes))
        rc = emulated["step"].step_launch(
            ctypes.byref(p), cfg.ncharge, 1, B, lanes, st.data_ptr(), ex.data_ptr(),
            c["nu_anom"].data_ptr(), c["omega_ce"].data_ptr(), c["scalars"].data_ptr(), coef.data_ptr(), None)
        assert rc == 0
        got[lanes] = st, ex
    for a, b in zip(got[224], got[256]):
        assert torch.equal(a[..., :NC], b[..., :NC])
    ref_state, ref_extras = state.clone(), torch.zeros((5, B, 224))
    fs.step_plain(ref_state, ref_extras, consts, cfg)
    pairs = [(f"state {j}", got[224][0][j], ref_state[j]) for j in range(state.shape[0])]
    pairs += [(f"extras {j}", got[224][1][j], ref_extras[j]) for j in range(5)]
    _assert_scaled_close(pairs)


@pytest.mark.parametrize("lanes", [32, 100, 288])
def test_emulated_launch_refuses_widths_off_the_warp(emulated, lanes):
    """A width that is no multiple of 32 from 64 to 256 lanes is refused by both
    kernels (cudaErrorInvalidValue), before any buffer is read."""
    p = _kernels.kernel_params(SolverConfig(num_cells=20, ncharge=1))
    p.K = 1
    assert emulated["kstep"].kstep_launch(ctypes.byref(p), 1, 1, 1, lanes, *([None] * 8)) == 1
    assert emulated["step"].step_launch(ctypes.byref(p), 1, 1, 1, lanes, *([None] * 7)) == 1
