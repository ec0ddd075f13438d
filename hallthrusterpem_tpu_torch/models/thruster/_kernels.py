"""Build and ctypes binding of the discharge solver's CUDA kernels: the K-step
kernel (``csrc/kstep.cu``) and the one-step kernel (``csrc/step.cu``), which share
their physics (``csrc/physics.cuh``).

Each source is built by ``kernel_build``, which compiles it at first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
under ``build/torch_kernels/`` at the root of the checkout, keyed by a hash of
the sources and the flags; the builds run in parallel. They include no PyTorch
header, so a build takes seconds, not minutes. Pointers come from
``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``; each launch returns the CUDA error
code, and the wrapper raises if it is not 0. There is no fallback: on a CUDA
tensor the wrapper launches the kernel or raises.

The wrappers may be called from several host threads at once (one per device of
a ``parallel.mesh.Mesh``): the launch counts and the per-device constants are
updated under a lock, and each launch passes its own copy of the config struct.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import numpy as np
import torch

from hallthrusterpem_tpu_torch import cuda_graph, kernel_build
from hallthrusterpem_tpu_torch.constants import ELECTRON_MASS, FUNDAMENTAL_CHARGE
from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig
from hallthrusterpem_tpu_torch.models.thruster.fused_step import (
    MAX_TRACE_STEPS,
    N_SLOTS,
    check_supported,
    lanes_for,
    n_state_for,
    rate_polys,
)
from hallthrusterpem_tpu_torch.models.thruster.rates import K_EN

_E = FUNDAMENTAL_CHARGE
_ME = ELECTRON_MASS
CSRC = Path(__file__).parent / "csrc"
#: kernel name -> source; each builds into a library of its own (``kernel_build.SOURCES``)
SOURCES = {name: kernel_build.SOURCES[name][0] for name in ("kstep", "step")}

#: launches of each kernel since the last reset (counted where the kernel is
#: launched, and for a launch captured in a CUDA graph at each replay)
launch_counts = {"kstep": 0, "step": 0}
#: per library, what its build did (``kernel_build.build_info``)
build_info = kernel_build.build_info

_libs: dict = {}
_lock = threading.Lock()
#: guards ``launch_counts`` and ``_coef_cache`` against concurrent launching threads
_state_lock = threading.Lock()
#: (propellant, ncharge, device) -> the rate coefficients on that device
_coef_cache: dict = {}


def reset_counts() -> None:
    with _state_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count(name: str) -> None:
    # under a CUDA graph's capture the launch is counted at each replay instead
    cuda_graph.count(launch_counts, name, _state_lock)


class KParams(ctypes.Structure):
    """Mirror of ``struct KParams`` in ``csrc/physics.cuh`` (same field order)."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "NC", "i0", "K", "avg_start", "num_steps", "n_levels", "solve_plume", "div_corr",
            "anode_sheath", "implicit_inel", "reconstruct", "ion_wall", "sheath_wall", "trace")]
        + [(n, ctypes.c_float) for n in (
            "dz", "mi", "inv_mi", "inv_dz", "half_inv_dz", "inv_dt", "c15_inv_dt", "neg_dt", "dt",
            "A_ch", "inv_A_ch", "a_i", "a_i_sq", "a_i2", "k_en", "rho_floor", "rho_ceil",
            "ne_floor", "Te_min", "Te_max", "anode_Te", "z_len", "L_ch", "nu_ew_c", "R_o", "R_i",
            "inv_area", "E", "E_ME", "inv_E", "two_pi_me", "two_thirds", "ten_ninth",
            "wall_recycling", "e_wall", "gmax", "ln_cross", "sq_mi_2pi_me", "coef_sheath",
            "wall_energy_scale", "ex_energy", "slow_ratio", "fast_ratio", "fast_frac", "slow_frac")]
        + [(n, ctypes.c_float * 3) for n in ("bohm_c", "zq", "zqE", "c_iw", "inv_mi_zq", "iz_c")]
        + [("rxn_e", ctypes.c_float * 6)]
    )


def kernel_params(cfg: SolverConfig) -> KParams:
    """The kernel's config constants: each is the float64 value of the constant
    subexpression of the model, rounded once to float32 by ctypes."""
    check_supported(cfg)
    mi, dt, dz = cfg.mi, cfg.dt, cfg.dz
    g = cfg.geometry
    rxn, (_, _, ex_energy) = rate_polys(cfg)
    zq = [1.0, 2.0, 3.0]
    inv_mi = 1.0 / mi
    a_i = float(np.sqrt(1.380649e-23 * cfg.ion_temp_K / mi))
    p = KParams(
        NC=cfg.nc, avg_start=cfg.avg_start_step, num_steps=cfg.num_steps,
        n_levels=max(1, int(np.ceil(np.log2(max(cfg.nc, 2))))),
        solve_plume=int(cfg.solve_plume), div_corr=int(cfg.apply_thrust_divergence_correction),
        anode_sheath=int(cfg.anode_sheath), implicit_inel=int(cfg.implicit_inelastic),
        reconstruct=int(cfg.reconstruct), ion_wall=int(cfg.ion_wall_losses),
        sheath_wall=int(cfg.wall_loss_type == "sheath"), trace=int(cfg.num_save > 0),
        dz=dz, mi=mi, inv_mi=inv_mi, inv_dz=1.0 / dz, half_inv_dz=0.5 * (1.0 / dz),
        inv_dt=1.0 / dt, c15_inv_dt=1.5 * (1.0 / dt), neg_dt=-dt, dt=dt,
        A_ch=g.channel_area, inv_A_ch=1.0 / g.channel_area, a_i=a_i, a_i_sq=a_i * a_i,
        a_i2=1.380649e-23 * cfg.ion_temp_K / mi, k_en=K_EN.get(cfg.propellant, 2.5e-13),
        rho_floor=float(1e10 * mi), rho_ceil=1e21 * mi, ne_floor=cfg.ne_floor,
        Te_min=cfg.Te_min, Te_max=cfg.Te_max, anode_Te=cfg.anode_Te,
        z_len=cfg.domain[1] - cfg.domain[0], L_ch=g.channel_length,
        nu_ew_c=cfg.electron_wall_losses * cfg.wall_momentum_scale * 1e7,
        R_o=g.outer_radius, R_i=g.inner_radius,
        inv_area=1.0 / (g.outer_radius**2 - g.inner_radius**2),
        E=_E, E_ME=_E / _ME, inv_E=1.0 / _E, two_pi_me=2.0 * np.pi * _ME,
        two_thirds=2.0 / 3.0, ten_ninth=10.0 / 9.0, wall_recycling=cfg.wall_recycling,
        e_wall=float(bool(cfg.electron_wall_losses)), gmax=cfg.see_gamma_max,
        ln_cross=float(np.log(cfg.see_crossover_eV)),
        sq_mi_2pi_me=float(np.sqrt(mi / (2 * np.pi * _ME))),
        coef_sheath=float(cfg.wall_energy_scale * 0.6 * np.sqrt(_E / mi) / g.channel_gap / 1.5),
        wall_energy_scale=cfg.wall_energy_scale, ex_energy=ex_energy,
        slow_ratio=cfg.slow_neutral_ratio, fast_ratio=cfg.fast_neutral_ratio,
        fast_frac=cfg.fast_neutral_fraction, slow_frac=1.0 - cfg.fast_neutral_fraction,
    )
    p.bohm_c[:] = [float(np.float32(-cfg.mdot_bohm_fraction) * np.sqrt(np.float32(z), dtype=np.float32))
                   for z in zq]
    p.zq[:] = zq
    p.zqE[:] = [z * _E for z in zq]
    p.c_iw[:] = [float(0.6 * np.sqrt(z) / g.channel_gap) for z in zq]
    p.inv_mi_zq[:] = [inv_mi * z for z in zq]
    p.iz_c[:] = [g.channel_area * _E * (z + 1) / mi for z in range(3)]
    p.rxn_e[:] = [e * inv_mi for *_, e in rxn] + [0.0] * (6 - len(rxn))
    return p


def rate_coefficients(cfg: SolverConfig) -> np.ndarray:
    """Flat float32 coefficient array read by the kernel: for each reaction its
    11 log-poly coefficients then the 10 of d(ln k)/d(ln Te); excitation last."""
    rxn, (ex, dex, _) = rate_polys(cfg)
    parts = [np.concatenate([c, dc]) for c, dc, *_ in rxn] + [np.concatenate([ex, dex])]
    assert all(len(x) == 21 for x in parts)
    return np.concatenate(parts).astype(np.float32)


def load_libraries() -> dict:
    """Build (once per source hash), load and bind both kernel libraries."""
    with _lock:
        if not _libs:
            loaded = {}
            for name in SOURCES:
                lib = kernel_build.library(name)
                size_fn = getattr(lib, f"{name}_params_size")
                size_fn.restype = ctypes.c_int
                if size_fn() != ctypes.sizeof(KParams):
                    raise RuntimeError(f"KParams layout mismatch in {name}: C {size_fn()} B, "
                                       f"ctypes {ctypes.sizeof(KParams)} B")
                launch = getattr(lib, f"{name}_launch")
                launch.restype = ctypes.c_int
                n_ptr = 8 if name == "kstep" else 7
                launch.argtypes = [ctypes.POINTER(KParams)] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * n_ptr
                if name == "kstep":
                    lib.kstep_occupancy.restype = ctypes.c_int
                    lib.kstep_occupancy.argtypes = [ctypes.c_int] * 3
                loaded[name] = lib
            _libs.update(loaded)
    return _libs


def kstep_blocks_per_sm(cfg: SolverConfig) -> int:
    """Blocks of the K-step kernel that one SM of the current card holds at once
    for ``cfg`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = load_libraries()["kstep"].kstep_occupancy(cfg.ncharge, cfg.neutral_groups, lanes_for(cfg))
    if n < 0:
        raise RuntimeError(f"kstep occupancy query failed with CUDA error {-n}")
    return n


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"kernel argument {name} must be a contiguous float32 {shape} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


@functools.lru_cache(maxsize=8)
def _cached_params(cfg: SolverConfig) -> KParams:
    # building the struct takes ~40 us, a one-step launch's worth; adaptive dt
    # makes a new config for nearly every batch, so only the last few are kept
    return kernel_params(cfg)


def _constants(cfg: SolverConfig, dev: torch.device):
    """A copy of the kernel's config struct, for this launch alone (the last few
    configs are kept), and the rate coefficients on ``dev`` (kept per
    propellant, charge-state count and device, the only inputs of the fits)."""
    ckey = (cfg.propellant, cfg.ncharge, dev)
    with _state_lock:
        if ckey not in _coef_cache:
            _coef_cache[ckey] = torch.as_tensor(rate_coefficients(cfg), device=dev)
        coef = _coef_cache[ckey]
    return KParams.from_buffer_copy(_cached_params(cfg)), coef


def kstep_cuda(state, prof, sacc, consts: dict, i0: int, K: int, cfg: SolverConfig) -> None:
    """Launch the K-step kernel for steps ``i0 .. i0+K-1``, in place on ``state``,
    ``prof`` and ``sacc``, on the current stream of their device. The launch
    takes the tensors' lane width: the layout's (``lanes_for``) on the main
    path; any other multiple of 32 that holds two padding lanes gives the same
    numbers on lanes 0..NC-1 (the kernel refuses the rest)."""
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"kstep_cuda: tensors must lie on a CUDA device, got {dev}")
    Z, LN = cfg.ncharge, state.shape[-1]
    B = state.shape[1]
    _check("state", state, (n_state_for(cfg), B, LN), dev)
    _check("prof", prof, (Z + 4, B, LN), dev)
    _check("sacc", sacc, (B, N_SLOTS), dev)
    _check("nu_anom", consts["nu_anom"], (B, LN), dev)
    _check("omega_ce", consts["omega_ce"], (B, LN), dev)
    _check("scalars", consts["scalars"], (B, N_SLOTS), dev)
    if K <= 0:
        raise ValueError(f"kstep: K={K} must be positive")
    if cfg.num_save > 0 and K > MAX_TRACE_STEPS:
        raise ValueError(f"kstep: K={K} exceeds the {MAX_TRACE_STEPS} trace lanes")
    lib = load_libraries()["kstep"]
    params, coef = _constants(cfg, dev)
    params.i0, params.K = int(i0), int(K)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kstep_launch(
            ctypes.byref(params), Z, cfg.neutral_groups, B, LN, state.data_ptr(), prof.data_ptr(),
            sacc.data_ptr(), consts["nu_anom"].data_ptr(), consts["omega_ce"].data_ptr(),
            consts["scalars"].data_ptr(), coef.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"kstep kernel launch failed with CUDA error {rc}")
    _count("kstep")


def step_cuda(state, extras, consts: dict, cfg: SolverConfig) -> None:
    """Launch the one-step kernel: one timestep in place on ``state``, writing
    ``extras`` (5, B, LN), on the current stream of their device. The circuit
    current is read from ``consts["scalars"][:, P_ICIR]``."""
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"step_cuda: tensors must lie on a CUDA device, got {dev}")
    LN = lanes_for(cfg)
    B = state.shape[1]
    _check("state", state, (n_state_for(cfg), B, LN), dev)
    _check("extras", extras, (5, B, LN), dev)
    _check("nu_anom", consts["nu_anom"], (B, LN), dev)
    _check("omega_ce", consts["omega_ce"], (B, LN), dev)
    _check("scalars", consts["scalars"], (B, N_SLOTS), dev)
    lib = load_libraries()["step"]
    params, coef = _constants(cfg, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.step_launch(
            ctypes.byref(params), cfg.ncharge, cfg.neutral_groups, B, LN, state.data_ptr(),
            extras.data_ptr(), consts["nu_anom"].data_ptr(), consts["omega_ce"].data_ptr(),
            consts["scalars"].data_ptr(), coef.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"step kernel launch failed with CUDA error {rc}")
    _count("step")
