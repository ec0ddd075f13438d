"""The plume's CUDA kernel (``models/csrc/plume.cu``) compiled with g++ against a
CPU emulation of the CUDA thread model (tests/cuda_cpu_emulation), launched
through the same argument packing as on the card (``plume.kernel_call``), against
the eager plain version ``current_density_plain``. This checks the kernel's
arithmetic, its warp shuffles and its handling of the rows the System sends it
on a machine without a GPU; the build and the run on the card are checked by the
`gpu` tests and chip_smoke.py.

Tolerance: scaled error (max |kernel - plain| / max |plain| per output, over the
finite values; the non-finite values must match) below 1e-6. Both round every
operation alike; they differ in the order of the two Simpson sums and in the
last bit of exp, cos, sin and acos (glibc's against PyTorch's). In float32 the
divergence angle is held to 5e-6: at a narrow beam arccos is steep, and the sum
order alone moves it by up to 2.1e-6 scaled over 1,472 rows drawn from the
inputs' distributions (the plain version's own products summed in order
instead of by ``torch.sum``), as far as the plain float32 version lies from its
float64 self (up to 1.2e-6)."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hallthrusterpem_tpu_torch import kernel_build
from hallthrusterpem_tpu_torch.models import plume
from test_torch_kstep_emulated import EMU

LAUNCH = re.compile(r"(plume_kernel<T>)<<<blocks, kThreads, 0, s>>>\((.*?)\);", re.S)
FULL_BATCH = 1472  # the predictive cell's rows a call
N_SPECIAL = 9  # the first rows of ``_rows``: the special cases
ALONE_STRIDE = 23  # beyond them, every 23rd row is also computed alone
TOL = 1e-6
DIV_ANGLE_TOL_F32 = 5e-6


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is needed to compile the kernel source for the CPU")
    out = tmp_path_factory.mktemp("plume_emu")
    src = kernel_build.SOURCES["plume"][0].read_text()
    assert LAUNCH.search(src), "kernel launch not found in plume.cu"
    cpp = out / "plume_emu.cpp"
    cpp.write_text(LAUNCH.sub(lambda m: f"emu_launch(blocks, kThreads, [&] {{ {m.group(1)}({m.group(2)}); }});",
                              src))
    lib_path = out / "libplume_emu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{EMU}",
         "-o", str(lib_path), str(cpp)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    lib.plume_args_size.restype = ctypes.c_int
    lib.plume_launch.restype = ctypes.c_int
    lib.plume_launch.argtypes = [ctypes.POINTER(plume.PlumeArgs), ctypes.c_int, ctypes.c_void_p]
    return lib


def _kernel(lib, inputs, sweep_radius=1.0):
    launches = []

    def launch(args, dtype_code):
        assert lib.plume_launch(ctypes.byref(args), dtype_code, None) == 0
        launches.append(dtype_code)

    out = plume.kernel_call(inputs, sweep_radius, launch)
    assert len(launches) == 1
    return out


def _rows(n, dtype, seed=0):
    """``n`` rows drawn from the pem_v0 SPT-100 plume inputs' distributions, with
    the Thruster's I_B0 and T; the first rows are the special cases."""
    rng = np.random.default_rng(seed)
    x = {
        "P_b": 10 ** rng.uniform(-8, -4, n), "c0": rng.uniform(0, 1, n), "c1": rng.uniform(0.1, 1, n),
        "c2": rng.uniform(-15, 15, n), "c3": rng.uniform(0.2, np.pi / 2, n),
        "c4": 10 ** rng.uniform(18, 22, n), "c5": 10 ** rng.uniform(14, 18, n),
        "sigma_cex": rng.uniform(51e-20, 58e-20, n), "I_B0": rng.uniform(2, 5, n), "T": rng.uniform(0.04, 0.1, n),
    }
    special = [
        {"c2": -15.0, "P_b": 1e-4, "c3": 0.1},  # alpha1 <= 0: the floor, div_angle from alpha 0.1
        {"c3": 0.0, "c2": 0.0},  # alpha1 == 0
        {"I_B0": -1.0},  # a negative density everywhere
        {"c0": 1.3, "c1": 0.2, "c2": 0.0, "c3": 0.2, "c4": 0.0, "c5": 0.0},  # a negative main beam, no CEX: j_ion < 0 near the axis
        {"I_B0": np.nan, "T": np.nan},  # a row the Thruster masked
        {"I_B0": np.nan},
        {"T": np.nan},
        {"c4": 0.0, "c5": 0.0, "c3": 0.05, "c2": 0.0, "c1": 0.9},  # no CEX, narrow beam: j_ion underflows
        {"c3": np.pi / 2, "c2": 15.0, "P_b": 1e-4, "c1": 0.1},  # alpha1 clamped to pi/2, wide scattered beam
    ]
    for i, row in enumerate(special[:n]):
        for k, v in row.items():
            x[k][i] = v
    return {k: torch.as_tensor(v, dtype=dtype) for k, v in x.items()}


def _assert_close(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        tol = DIV_ANGLE_TOL_F32 if (k == "div_angle" and r.dtype == torch.float32) else TOL
        assert g.shape == r.shape and g.dtype == r.dtype, k
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(g), fin), k
        assert torch.equal(torch.isnan(g), torch.isnan(r)), k
        if fin.any():
            err = float((g[fin] - r[fin]).abs().max() / r[fin].abs().max().clamp_min(1e-300))
            assert err < tol, (k, err)


def test_args_layout_matches(emulated):
    assert emulated.plume_args_size() == ctypes.sizeof(plume.PlumeArgs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_T", [True, False])
def test_emulated_kernel_matches_plain(emulated, dtype, with_T):
    x = _rows(64, dtype)
    if not with_T:
        del x["T"]
    ref = plume.current_density_plain(x)
    got = _kernel(emulated, x)
    _assert_close(got, ref)
    # the special rows: the floors, the masked rows' NaN, the clamp
    j, d = got["j_ion"], got["div_angle"]
    floor = torch.tensor(1e-20, dtype=dtype)
    for i in (0, 1, 2, 3, 7):
        assert torch.equal(j[i], floor.expand(91)), i
    assert torch.isfinite(j[8]).all() and bool((j[8] > floor).all())
    assert torch.equal(j[4], floor.expand(91)) and torch.isnan(d[4]) and torch.isnan(d[5])
    assert torch.isfinite(d[[0, 1, 2, 3, 6, 7, 8]]).all()
    if with_T:
        assert torch.isnan(got["T_c"][[4, 5, 6]]).all() and torch.isfinite(got["T_c"][[0, 1, 2, 7, 8]]).all()


@pytest.mark.parametrize("wide", [("I_B0",), ("I_B0", "T"), ("T", "c4", "P_b")])
def test_emulated_kernel_reads_each_input_in_its_own_type(emulated, wide):
    """The Thruster's I_B0 and T come in float64 beside float32 inputs: the
    kernel reads them as they are and rounds them as ``.to`` does, and T_c takes
    the type ``T * cos_div`` promotes to."""
    x = _rows(40, torch.float32, seed=3)
    x.update({k: x[k].double() for k in wide})
    ref = plume.current_density_plain(x)
    got = _kernel(emulated, x)
    _assert_close(got, ref)
    assert got["T_c"].dtype == ref["T_c"].dtype


@pytest.mark.parametrize("radius", [0.5, 1.0, 2.5])
def test_emulated_kernel_at_other_radii_and_broadcast_inputs(emulated, radius):
    """Scalar (0-d) and broadcast inputs are read in place, with a stride of 0."""
    x = _rows(12, torch.float32, seed=2)
    x["c1"] = torch.tensor(0.5)
    x["sigma_cex"] = torch.tensor([5.5e-19]).expand(12)
    ref = plume.current_density_plain(x, sweep_radius=radius)
    _assert_close(_kernel(emulated, x, radius), ref)


def test_emulated_kernel_is_batch_invariant(emulated):
    """A row computed alone is the same row of a batch of 1,472, bit for bit
    (float32, the System's type): the special rows and every 23rd row beyond
    them, the last row among them."""
    x = _rows(FULL_BATCH, torch.float32, seed=1)
    batch = _kernel(emulated, x)
    _assert_close(batch, plume.current_density_plain(x))
    alone_rows = [*range(N_SPECIAL), *range(N_SPECIAL, FULL_BATCH, ALONE_STRIDE), FULL_BATCH - 1]
    for i in alone_rows:
        alone = _kernel(emulated, {k: v[i:i + 1] for k, v in x.items()})
        for k in ("j_ion", "div_angle", "T_c"):
            a, b = alone[k][0].numpy(), batch[k][i].numpy()
            assert a.tobytes() == b.tobytes(), (i, k)


def test_current_density_on_the_cpu_takes_the_plain_version(monkeypatch):
    """On the CPU the dispatcher calls the eager plain version, unchanged, and
    counts its rows as eager; it loads no kernel."""
    from hallthrusterpem_tpu_torch import tracing

    monkeypatch.setattr(plume, "_library", lambda: pytest.fail("the CPU route loaded the kernel"))
    x = _rows(7, torch.float32)
    tracing.reset_counts()
    got = plume.current_density(x)
    ref = plume.current_density_plain(x)
    for k in ref:
        assert torch.equal(torch.isnan(got[k]), torch.isnan(ref[k]))
        assert torch.equal(torch.nan_to_num(got[k]), torch.nan_to_num(ref[k])), k
    assert tracing.counts["plume_eager_rows"] == 7 and tracing.counts["plume_kernel_rows"] == 0
    assert plume.launch_counts["plume"] == 0
