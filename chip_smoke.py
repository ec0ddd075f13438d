#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--duration SECONDS]

Phases, each printed with its seconds:

1. device: the card's name, and its name and power limit from ``nvidia-smi``;
2. build: the K-step kernel (``csrc/kstep.cu``) with nvcc, and ptxas's
   register / shared-memory / spill lines;
3. kernel against its plain PyTorch version on the card at the main path's
   shapes (fidelity (2,2): 202 cells, 256 lanes, 3 charge states, plume on;
   B = 1024): one K = 50 launch against 50 plain steps from the same state, every
   state array, profile sum and accumulator slot; then 20 launches against 1,000
   plain steps, the accumulators;
4. main path: ``CoupledPEM(model_fidelity=(2,2), duration=2e-5)`` (9,138 steps)
   at B = 1024, one warm run and two timed runs, with the launch count checked;
5. coupled outputs against the plain version: B = 16, 914 steps;
6. the kernel's time per launch at B = 1024, its plain version's and its bound.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; without
a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
KERNEL_SOURCE = "hallthrusterpem_tpu_torch/models/thruster/csrc/kstep.cu"
KERNEL_REPLACES = "hallthrusterpem_tpu/models/thruster/pallas_step.py:677"
STATE_RTOL = 1e-4  # one launch vs 50 plain steps (the CPU tests' step-level bound)
QOI_RTOL = 1e-2  # time-averaged QoIs (the CPU tests' run-level bound)


def log(msg: str) -> None:
    print(msg, flush=True)


def scaled_err(a, b) -> float:
    """max |a - b| / max |b|: the error in units of the array's own scale."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def count_ops(fn) -> int:
    """Float operations of ``fn``: one per output element of every arithmetic
    aten operator it dispatches (data movement and views are not counted)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "exp", "log", "sqrt", "rsqrt", "reciprocal",
             "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "where", "sign", "abs",
             "pow", "lt", "le", "gt", "ge", "eq", "ne", "isfinite", "logical_not", "logical_or",
             "bitwise_or", "bitwise_not", "any", "sum", "rsub"}

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in arith:
                numel = max((a.numel() for a in args if isinstance(a, torch.Tensor)), default=1)
                Counter.n += max(numel, out.numel() if isinstance(out, torch.Tensor) else 1)
            return out

    with Counter():
        fn()
    return Counter.n


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=2e-5,
                    help="simulated seconds of the main-path run (bench.py uses 5e-4)")
    args = ap.parse_args()
    t_all = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script checks the port on a GPU")

    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.pem import (
        CoupledPEM,
        _coupled_post,
        _coupled_pre,
        default_coupled_inputs,
    )

    # ---- 1. device
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0].strip()
    log(f"[1 device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s); nvidia-smi: {smi_line} "
        f"({time.perf_counter() - t0:.2f} s)")

    # ---- 2. build
    t0 = time.perf_counter()
    _kernels.load_library()
    info = _kernels.build_info
    log(f"[2 build] kstep.cu -> {info['path']} in {info['seconds']:.2f} s (cached={info['cached']})")
    for line in info["log"].splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
            log("    " + line.strip())
    log(f"[2 build] done ({time.perf_counter() - t0:.2f} s)")

    # ---- 3. kernel vs plain version on the card, at the main path's shapes
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    batch = 1024
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=args.duration, device=dev)
    cfg = dataclasses.replace(pem.cfg, average_start_time=0.0)  # accumulate from step 0
    gen = torch.Generator().manual_seed(7)
    params, _ = _coupled_pre(default_coupled_inputs(batch, gen, spread=0.08, device=dev), cfg)
    consts, state0, prof0, sacc0 = fs.init_carry(params, pem.base_B, cfg)
    physics = fs.Physics(cfg)
    K = fs.INNER_STEPS

    def run(block, n_launch):
        s, p, a = state0.clone(), prof0.clone(), sacc0.clone()
        for j in range(n_launch):
            block(s, p, a, consts, j * K, K, cfg, physics)
        torch.cuda.synchronize()
        return s, p, a

    ks, kp, ka = run(fs.kstep, 1)
    ps, pp, pa = run(fs.kstep_plain, 1)
    for name, x in (("state", ks), ("prof", kp), ("sacc", ka)):
        assert torch.isfinite(x).all(), f"kernel {name} not finite"
    pairs = [(ks[j], ps[j]) for j in range(ks.shape[0])] + [(kp[j], pp[j]) for j in range(kp.shape[0])]
    pairs += [(ka[:, j], pa[:, j]) for j in range(fs.A_ICIR + 1)]
    errs = [scaled_err(k, p) for k, p in pairs]
    max_err = max(errs)
    max_abs = max(float((k - p).abs().max()) for k, p in pairs)
    log(f"[3 parity] 1 launch (K={K}) vs {K} plain steps, B={batch}: max scaled error {max_err:.3e} "
        f"(tolerance {STATE_RTOL:g}), max absolute error {max_abs:.3e} over {len(pairs)} arrays")
    assert max_err < STATE_RTOL, errs
    ks, kp, ka = run(fs.kstep, 20)
    ps, pp, pa = run(fs.kstep_plain, 20)
    acc_err = max(float(((ka[:, j] - pa[:, j]).abs() / pa[:, j].abs().clamp_min(1e-30)).max())
                  for j in (fs.A_THRUST, fs.A_ID, fs.A_ID2, fs.A_IB0, fs.A_MDOT, fs.A_UEXIT))
    assert torch.equal(ka[:, fs.A_FAILED], pa[:, fs.A_FAILED])
    log(f"[3 parity] 20 launches vs {20 * K} plain steps: accumulators max relative error "
        f"{acc_err:.3e} (tolerance {QOI_RTOL:g}) ({time.perf_counter() - t0:.2f} s)")
    assert acc_err < QOI_RTOL
    # free phase 3's B = 1024 copies so phase 4's peak memory is the main path's own
    del params, consts, state0, prof0, sacc0, ks, kp, ka, ps, pp, pa, pairs

    # ---- 4. main path: CoupledPEM at fidelity (2,2), B = 1024
    t0 = time.perf_counter()
    n_launch = math.ceil(pem.cfg.num_steps / fs.INNER_STEPS)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    out = pem(default_coupled_inputs(batch, torch.Generator().manual_seed(42), spread=0.08, device=dev))
    torch.cuda.synchronize()
    walls = []
    for trial in range(2):
        inp = default_coupled_inputs(batch, torch.Generator().manual_seed(trial), spread=0.08, device=dev)
        t1 = time.perf_counter()
        out = pem(inp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    launches = dict(_kernels.launch_counts)
    wall = min(walls)
    thrust = out["T"]
    n_ok = int(torch.isfinite(thrust).sum())
    sim_ms_per_s = batch * pem.cfg.duration * 1e3 / wall
    log(f"[4 main path] {pem.cfg.num_steps} steps x B={batch}: walls {walls[0]:.3f} / {walls[1]:.3f} s, "
        f"{sim_ms_per_s:.2f} sim-ms/s, {wall / pem.cfg.num_steps * 1e6:.2f} us/step, "
        f"finite {n_ok}/{batch}, mean T {float(thrust[torch.isfinite(thrust)].mean()):.5f} N, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
        f"kstep launches {launches['kstep']} ({time.perf_counter() - t0:.2f} s)")
    assert launches["kstep"] == 3 * n_launch, (launches, n_launch)
    assert n_ok >= batch - 10, n_ok
    for k in ("T", "I_d", "I_B0", "j_ion"):
        assert out[k].shape[0] == batch
    assert out["j_ion"].shape == (batch, 91) and out["u_ion"].shape == (batch, pem.cfg.nc)

    # ---- 5. coupled outputs vs the plain version: B = 16, 914 steps
    t0 = time.perf_counter()
    small = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=2e-6, device=dev)
    inp = default_coupled_inputs(16, torch.Generator().manual_seed(3), spread=0.08, device=dev)
    got = small(inp)
    sp, v_cc = _coupled_pre(inp, small.cfg)
    ref = _coupled_post(inp, v_cc, fs.simulate_batch_multi(sp, small.base_B, small.cfg,
                                                           block=fs.kstep_plain),
                        small.sweep_radius, small.cfg)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(got["T"]), torch.isfinite(ref["T"]))
    ok = torch.isfinite(ref["T"])
    qoi_err = max(float(((got[k] - ref[k]).abs() / ref[k].abs())[ok].max()) for k in ("T", "I_d", "I_B0"))
    log(f"[5 coupled parity] B=16, {small.cfg.num_steps} steps: T/I_d/I_B0 max relative error "
        f"{qoi_err:.3e} (tolerance {QOI_RTOL:g}), finite {int(ok.sum())}/16 "
        f"({time.perf_counter() - t0:.2f} s)")
    assert qoi_err < QOI_RTOL and int(ok.sum()) > 0

    # ---- 6. the kernel's time, its plain version's and its bound, at B = 1024, K = 50
    t0 = time.perf_counter()
    params, _ = _coupled_pre(default_coupled_inputs(batch, torch.Generator().manual_seed(5),
                                                    spread=0.08, device=dev), pem.cfg)
    consts, state, prof, sacc = fs.init_carry(params, pem.base_B, pem.cfg)
    physics = fs.Physics(pem.cfg)
    launch = lambda block: block(state, prof, sacc, consts, 0, K, pem.cfg, physics)
    launch(fs.kstep)
    ms = cuda_ms(lambda: launch(fs.kstep), 20)
    plain_ms = cuda_ms(lambda: launch(fs.kstep_plain), 1)
    ops1 = count_ops(lambda: fs.kstep_plain(state, prof, sacc, consts, 0, 1, pem.cfg, physics))
    ops2 = count_ops(lambda: fs.kstep_plain(state, prof, sacc, consts, 0, 2, pem.cfg, physics))
    ops = (ops1 - (ops2 - ops1)) + K * (ops2 - ops1)
    n_bytes = 4 * (2 * (state.numel() + prof.numel() + sacc.numel())
                   + consts["nu_anom"].numel() + consts["omega_ce"].numel() + consts["scalars"].numel())
    ops_ms, bytes_ms = ops / H100_F32_FLOPS * 1e3, n_bytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    lanes = batch * fs.lanes_for(pem.cfg)
    log(f"[6 timing] kstep B={batch} K={K}: {ms:.3f} ms/launch ({ms / K * 1e3:.2f} us/step), "
        f"plain {plain_ms:.1f} ms; {(ops2 - ops1) / lanes:.0f} ops per lane-step, "
        f"{ops:.3e} ops and {n_bytes:.3e} bytes per launch -> bound {bound_ms:.4f} ms "
        f"(ops {ops_ms:.4f}, bytes {bytes_ms:.4f}) ({time.perf_counter() - t0:.2f} s)")

    kernels = [{
        "name": "kstep", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches["kstep"], "max_abs_err": max_abs, "max_scaled_err": max_err,
        "scaled_err_tolerance": STATE_RTOL, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
