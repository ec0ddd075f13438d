"""Semi-empirical ion-current-density plume model (the JAX package's
``models/plume.py``): two-Gaussian beam plus charge-exchange background over a
91-point, 0-90 degree sweep, with the erfi normalisation in overflow-free form.

:func:`current_density` chooses by the inputs' device: on a CUDA card the whole
function is one launch of a hand-written kernel (``csrc/plume.cu``, built with
the solver's kernels by ``kernel_build``); on the CPU it is
:func:`current_density_plain`, eager PyTorch, which the CPU tests hold against
the JAX package. There is no fallback: on a CUDA tensor the kernel runs or the
call raises. ``launch_counts["plume"]`` counts the kernel's launches, and
``tracing.counts`` the rows each route took (``plume_kernel_rows``,
``plume_eager_rows``)."""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from hallthrusterpem_tpu_torch import cuda_graph, kernel_build, tracing
from hallthrusterpem_tpu_torch.constants import TORR_2_PA
from hallthrusterpem_tpu_torch.ops import special
from hallthrusterpem_tpu_torch.ops.integrate import simpson, simpson_weights
from hallthrusterpem_tpu_torch.ops.special import exp_neg_asq_re_erfi, exp_neg_sq_erfi

__all__ = ["current_density", "current_density_plain"]

_N_ANGLES = 91
_ALPHA_RAD = np.linspace(0.0, np.pi / 2, _N_ANGLES)
_SIMPSON_W = simpson_weights(_ALPHA_RAD)
#: pi^{3/2}/2 of the Gaussian normalisation
_NORM = float(np.pi ** 1.5 / 2.0)
#: alpha1 in place of a non-positive one, so the normalisation stays finite
_ALPHA_OFF = 0.1
#: j_ion of a row whose alpha1 or density is not positive
_FLOOR_J = 1e-20
#: the kernel's inputs, in the order of ``PlumeArgs.in`` in csrc/plume.cu
_INPUTS = ("P_b", "c0", "c1", "c2", "c3", "c4", "c5", "sigma_cex", "I_B0", "T")
#: the kernel's types, by the code ``plume_launch`` takes
_DTYPES = {torch.float32: 0, torch.float64: 1}

#: launches of the plume's kernel since the last reset (a launch captured in a
#: CUDA graph is counted at each replay)
launch_counts = {"plume": 0}
_lock = threading.Lock()
#: (dtype, device) -> the (4, 91) angle grid, cos, sin and Simpson weights there
_grids: dict = {}


def _gaussian_norm(alpha: torch.Tensor) -> torch.Tensor:
    """``(pi^{3/2}/2) alpha exp(-(alpha/2)^2) C(alpha)``: the inverse of the
    forward-hemisphere solid-angle integral of ``exp(-(theta/alpha)^2)``."""
    a = alpha / 2.0
    b = torch.full_like(alpha, np.pi) / (2.0 * alpha)  # a true divide, as in the JAX model
    combo = 2.0 * (exp_neg_sq_erfi(a) - exp_neg_asq_re_erfi(a, b))
    return _NORM * alpha * combo


def current_density(inputs: dict, sweep_radius: float = 1.0) -> dict:
    """Ion current density ``j_ion`` (batch, 91) at one sweep radius [m], the
    divergence angle, the angle grid ``j_ion_coords`` [rad] and, when ``T`` is
    given, the divergence-corrected thrust ``T_c``: one kernel launch when
    ``P_b`` lies on a CUDA device, else :func:`current_density_plain`.

    :param inputs: (batch,) tensors ``P_b`` (Torr), ``c0..c5``, ``sigma_cex`` (m^2),
        ``I_B0`` (A); optional ``T`` (N).
    """
    if inputs["P_b"].device.type == "cuda":
        return _current_density_cuda(inputs, sweep_radius)
    tracing.count(plume_eager_rows=math.prod(_batch_shape(inputs)))
    return current_density_plain(inputs, sweep_radius)


def _batch_shape(inputs: dict) -> torch.Size:
    shapes = {inputs[k].shape for k in _INPUTS[:-1]}
    return shapes.pop() if len(shapes) == 1 else torch.broadcast_shapes(*shapes)


def current_density_plain(inputs: dict, sweep_radius: float = 1.0) -> dict:
    """:func:`current_density` in eager PyTorch on any device: the kernel's plain
    version, and the CPU route."""
    P_B = inputs["P_b"] * TORR_2_PA
    dt, dev = P_B.dtype, P_B.device
    batch = torch.broadcast_shapes(*(inputs[k].shape for k in (
        "P_b", "c0", "c1", "c2", "c3", "c4", "c5", "sigma_cex", "I_B0")))
    bc = lambda x: torch.broadcast_to(x.to(dt), batch)
    P_B = bc(P_B)
    c0, c1, c2, c3, c4, c5, sigma_cex, I_B0 = (bc(inputs[k]) for k in (
        "c0", "c1", "c2", "c3", "c4", "c5", "sigma_cex", "I_B0"))
    radius = float(sweep_radius)
    alpha_rad = torch.as_tensor(_ALPHA_RAD, dtype=dt, device=dev)

    n = c4 * P_B + c5  # facility neutral density (m^-3)
    alpha1 = torch.clamp(c2 * P_B + c3, max=np.pi / 2)  # main-beam divergence (rad)
    valid = alpha1 > 0
    alpha1_safe = torch.where(valid, alpha1, _ALPHA_OFF)  # keep the normalisation finite off-branch
    alpha2 = alpha1_safe / c1  # scattered-beam divergence (rad)

    A1 = (1 - c0) / _gaussian_norm(alpha1_safe)
    A2 = c0 / _gaussian_norm(alpha2)

    ex = lambda x: x[..., None]
    decay = torch.exp(-radius * ex(n) * ex(sigma_cex))  # (..., 1)
    j_cex = ex(I_B0) * (1 - decay) / (2 * np.pi * radius**2)
    base = ex(I_B0) * decay / radius**2
    j_beam = base * ex(A1) * torch.exp(-((alpha_rad / ex(alpha1_safe)) ** 2))
    j_scat = base * ex(A2) * torch.exp(-((alpha_rad / ex(alpha2)) ** 2))
    j_ion = j_beam + j_scat + j_cex  # (..., 91)

    # alpha1 <= 0 or any nonpositive density -> flat 1e-20 floor
    valid = valid & torch.all(j_ion > 0, dim=-1)
    j_ion = torch.where(valid[..., None], j_ion, _FLOOR_J)

    # divergence angle: first moment of the flipped non-CEX profile
    w = torch.as_tensor(_SIMPSON_W, dtype=dt, device=dev)
    j_non_cex = torch.flip(j_beam + j_scat, dims=(-1,))
    den_igd = j_non_cex * torch.cos(alpha_rad)
    num_igd = den_igd * torch.sin(alpha_rad)
    cos_div = simpson(num_igd, weights=w) / simpson(den_igd, weights=w)
    cos_div = torch.where(torch.isfinite(cos_div), cos_div, torch.nan)
    div_angle = torch.arccos(torch.clamp(cos_div, -1.0, 1.0))

    out = {"j_ion": j_ion, "div_angle": div_angle}
    if inputs.get("T") is not None:
        out["T_c"] = inputs["T"] * cos_div
    out["j_ion_coords"] = torch.broadcast_to(alpha_rad, batch + (_N_ANGLES,))
    return out


class PlumeArgs(ctypes.Structure):
    """Mirror of ``struct PlumeArgs`` in ``csrc/plume.cu`` (same field order)."""

    _fields_ = (
        [("inputs", ctypes.c_void_p * len(_INPUTS)), ("strides", ctypes.c_longlong * len(_INPUTS))]
        + [(n, ctypes.c_void_p) for n in ("grid", "j_ion", "div_angle", "T_c")]
        + [(n, ctypes.c_int) for n in ("rows", "has_T", "in_f64", "Tc_f64")]
        + [("coef", ctypes.c_double * len(special._A))]
        + [(n, ctypes.c_double) for n in (
            "L", "inv_sqrt_pi", "sqrt_pi_2", "two_sqrt_pi", "norm", "torr_2_pa", "half_pi", "pi",
            "alpha_off", "floor_j", "neg_radius", "radius_sq", "cex_area")]
    )


def _grid(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The angle grid, its cosines and sines and the Simpson weights, (4, 91) in
    ``dtype`` on ``device``, computed there by PyTorch as the plain version
    computes them; made once per type and device."""
    key = (dtype, device)
    grid = _grids.get(key)
    if grid is None:
        alpha = torch.as_tensor(_ALPHA_RAD, dtype=dtype, device=device)
        w = torch.as_tensor(_SIMPSON_W, dtype=dtype, device=device)
        grid = torch.stack([alpha, torch.cos(alpha), torch.sin(alpha), w])
        with _lock:
            grid = _grids.setdefault(key, grid)
    return grid


@functools.lru_cache(maxsize=16)
def _constants(sweep_radius: float) -> PlumeArgs:
    # each constant the plain version's Python float, rounded to the kernel's type there
    radius = float(sweep_radius)
    return PlumeArgs(
        coef=(ctypes.c_double * len(special._A))(*map(float, special._A)), L=special._L,
        inv_sqrt_pi=special._INV_SQRT_PI, sqrt_pi_2=special._SQRT_PI_2,
        two_sqrt_pi=special._TWO_SQRT_PI, norm=_NORM, torr_2_pa=TORR_2_PA,
        half_pi=np.pi / 2, pi=np.pi, alpha_off=_ALPHA_OFF, floor_j=_FLOOR_J, neg_radius=-radius,
        radius_sq=radius**2, cex_area=2 * np.pi * radius**2)


def kernel_call(inputs: dict, sweep_radius: float, launch) -> dict:
    """The plume kernel's outputs on the inputs' device: the arguments packed,
    the outputs allocated with ``torch.empty`` and ``launch(args, dtype_code)``
    called once (no launch for an empty batch). The kernel computes in
    ``P_b``'s type, as the plain version does; it reads each float32 or float64
    input in place, in its own type, where its batch is the call's or a
    broadcast of one value (any other input is first made so)."""
    dt, dev = inputs["P_b"].dtype, inputs["P_b"].device
    if dt not in _DTYPES:
        raise TypeError(f"current_density: the plume kernel takes float32 or float64, got {dt}")
    batch = _batch_shape(inputs)
    rows = math.prod(batch)
    has_T = inputs.get("T") is not None
    args = PlumeArgs.from_buffer_copy(_constants(float(sweep_radius)))
    kept = []  # inputs made anew, alive until the launch
    for k, name in enumerate(_INPUTS[: len(_INPUTS) - (not has_T)]):
        x = inputs[name]
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"current_density: the plume kernel has no gradient ({name} requires grad)")
        if x.device != dev or x.dtype not in _DTYPES:
            x = x.to(dev, dt)
        if x.dim() == 0 or x.numel() == 1:
            stride = 0
        elif x.shape == batch and x.dim() == 1:
            stride = x.stride(0)
        else:
            x = torch.broadcast_to(x, batch).reshape(-1)
            stride = x.stride(0)
        kept.append(x)
        args.inputs[k], args.strides[k] = x.data_ptr(), stride
        args.in_f64 |= int(x.dtype == torch.float64) << k
    grid = _grid(dt, dev)
    j_ion = torch.empty(batch + (_N_ANGLES,), dtype=dt, device=dev)
    div_angle = torch.empty(batch, dtype=dt, device=dev)
    out = {"j_ion": j_ion, "div_angle": div_angle}
    if has_T:
        tc_dtype = torch.promote_types(inputs["T"].dtype, dt)
        if tc_dtype not in _DTYPES:
            raise TypeError(f"current_density: T_c would be {tc_dtype}")
        out["T_c"] = torch.empty(batch, dtype=tc_dtype, device=dev)
        args.T_c, args.Tc_f64 = out["T_c"].data_ptr(), int(tc_dtype == torch.float64)
    args.grid, args.j_ion, args.div_angle = grid.data_ptr(), j_ion.data_ptr(), div_angle.data_ptr()
    args.rows, args.has_T = rows, int(has_T)
    if rows:
        launch(args, _DTYPES[dt])
    out["j_ion_coords"] = torch.broadcast_to(grid[0], batch + (_N_ANGLES,))
    return out


@functools.lru_cache(maxsize=1)
def _library():
    lib = kernel_build.library("plume")
    lib.plume_args_size.restype = ctypes.c_int
    if lib.plume_args_size() != ctypes.sizeof(PlumeArgs):
        raise RuntimeError(f"PlumeArgs layout mismatch: C {lib.plume_args_size()} B, "
                           f"ctypes {ctypes.sizeof(PlumeArgs)} B")
    lib.plume_launch.restype = ctypes.c_int
    lib.plume_launch.argtypes = [ctypes.POINTER(PlumeArgs), ctypes.c_int, ctypes.c_void_p]
    return lib


def _current_density_cuda(inputs: dict, sweep_radius: float) -> dict:
    lib = _library()
    dev = inputs["P_b"].device

    def launch(args, dtype_code):
        with torch.cuda.device(dev):
            rc = lib.plume_launch(ctypes.byref(args), dtype_code, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"plume kernel launch failed with CUDA error {rc}")
        cuda_graph.count(launch_counts, "plume", _lock)

    out = kernel_call(inputs, sweep_radius, launch)
    tracing.count(plume_kernel_rows=out["div_angle"].numel())
    return out


def reset_counts() -> None:
    with _lock:
        launch_counts["plume"] = 0
