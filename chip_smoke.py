#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--duration SECONDS]

Phases, each printed with its seconds:

1. device: the card's name, and its name and power limit from ``nvidia-smi``;
2. build: the K-step kernel (``csrc/kstep.cu``) and the one-step kernel
   (``csrc/step.cu``), one nvcc each, started together, and ptxas's
   register / shared-memory / spill lines; the K-step kernel's blocks per SM
   at the main path's config, and from its SASS (``cuobjdump``) the block
   barriers and instructions of one step and the instruction count by opcode;
3. kernel against its plain PyTorch version on the card at the main path's
   shapes (fidelity (2,2): 202 cells, 256 lanes, 3 charge states, plume on;
   B = 1024): one K = 50 launch against 50 plain steps from the same state, every
   state array, profile sum and accumulator slot; then 20 launches against 1,000
   plain steps, the accumulators;
4. main path: ``CoupledPEM(model_fidelity=(2,2), duration=2e-5)`` (9,138 steps)
   at B = 1024, one warm run and two timed runs, with the launch count checked;
5. coupled outputs against the plain version: B = 16, 914 steps;
6. the kernel's time per launch at B = 1024, its plain version's and its bound,
   beside its block barriers per step; the SM clock under load, and the time a
   step would take at that clock if every scheduler issued every cycle;
7. the K-step kernel's variants against the plain version at B = 1024, fidelity
   (2,2): one launch with the I_d(t) trace lanes, one with two neutral groups;
8. the one-step kernel against its plain version: one step at B = 1024, the
   state and all five output arrays;
9. the wrapper path: ``hallthruster_jl`` with the pem_v0 SPT-100 Thruster
   component (``configs/pem_v0_SPT-100_thruster.json``) at fidelity (2,2),
   B = 1024, ``num_save`` 1000 and the cycle average, cut to ``WRAPPER_DURATION``
   (5e-4 s, the bench length); one warm run and two timed runs, the
   launch count checked, the raw averages the failure guards judge; then the
   kernel's time per launch on this config, with the trace lanes and without;
10. the one-step driver against the K-step driver: B = 1024, 914 steps;
11. the one-step kernel's time per launch, its plain version's and its bound.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; without
a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
KERNEL_SOURCE = "hallthrusterpem_tpu_torch/models/thruster/csrc/kstep.cu"
KERNEL_REPLACES = "hallthrusterpem_tpu/models/thruster/pallas_step.py:677"
STEP_SOURCE = "hallthrusterpem_tpu_torch/models/thruster/csrc/step.cu"
STEP_REPLACES = "hallthrusterpem_tpu/models/thruster/pallas_step.py:574"
STATE_RTOL = 1e-4  # one launch vs 50 plain steps (the CPU tests' step-level bound)
QOI_RTOL = 1e-2  # time-averaged QoIs (the CPU tests' run-level bound)
# simulated seconds of the wrapper-path run, the bench length: the component's
# failure guards judge time averages, and before ~0.2 ms the averaging window
# lies in the ignition transient, where they reject every row
WRAPPER_DURATION = 5e-4


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


def kernel_sass(lib_path: str, kernel: str) -> list:
    """SASS of the kernel whose mangled name contains ``kernel``, from
    ``cuobjdump -sass`` of the built library: one (address, opcode with its
    modifiers, branch target or None) triple per instruction."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel in fn.split("\n", 1)[0]:
            out = []
            for addr, op, rest in re.findall(
                    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", fn):
                tgt = re.search(r"0x([0-9a-f]+)\s*$", rest) if op.split(".")[0] == "BRA" else None
                out.append((int(addr, 16), op, int(tgt.group(1), 16) if tgt else None))
            return out
    raise RuntimeError(f"no kernel {kernel} in the SASS of {lib_path}")


def step_loop_counts(sass: list, n_levels: int) -> tuple:
    """Block barriers and instructions one step of the K-step kernel issues per
    warp, read from its SASS. A loop is a backward branch; the step loop is the
    outermost loop that holds a barrier, and the one loop it may hold is the
    PCR's (``#pragma unroll 1`` in physics.cuh), which runs ``n_levels`` times a
    step. Instructions are static: both sides of a branch count, and the
    subroutines it calls (the slow paths of IEEE division) do not."""
    heads: dict = {}
    for addr, _, tgt in sass:
        if tgt is not None and tgt < addr:
            heads[tgt] = max(addr, heads.get(tgt, addr))
    loops = sorted(heads.items(), key=lambda lo: lo[0] - lo[1])  # outermost first
    inside = lambda lo: [x for x in sass if lo[0] <= x[0] <= lo[1]]
    bars = lambda xs: sum(op.startswith("BAR.") for _, op, _ in xs)
    step = next(lo for lo in loops if bars(inside(lo)))
    inner = [lo for lo in loops if lo != step and step[0] <= lo[0] <= step[1]]
    if len(inner) != 1 or not bars(inside(inner[0])):
        raise RuntimeError(f"step loop {step} holds loops {inner}, not the PCR's alone")
    body, pcr = inside(step), inside(inner[0])
    return (bars(body) + (n_levels - 1) * bars(pcr), len(body) + (n_levels - 1) * len(pcr))


def sm_clock_under_load(launch, n_launch: int) -> list:
    """SM clocks (MHz) that ``nvidia-smi`` reads while the card runs ``n_launch``
    back-to-back launches; only reads that ended before the last launch did."""
    import torch

    done = torch.cuda.Event()
    for _ in range(n_launch):
        launch()
    done.record()
    reads = []
    for _ in range(5):
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        if done.query():
            break
        reads.append(float(out.split()[0]))
    torch.cuda.synchronize()
    return reads


def cuda_ms(fn, reps: int, lead: bool = False) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls, between CUDA events.
    With ``lead`` the card first spins for ~10 ms (2e7 cycles) so that the host
    enqueues every timed call before the first one starts: the events then
    bracket back-to-back kernels, not the host's launch pace, which a kernel of a
    few tens of µs launched through Python checks and ctypes would measure."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if lead:
        torch.cuda._sleep(20_000_000)
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

    import hallthrusterpem_tpu_torch.models.thruster as thruster
    from hallthrusterpem_tpu_torch.constants import FUNDAMENTAL_CHARGE
    from hallthrusterpem_tpu_torch.models.cathode import cathode_coupling
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.models.thruster.one_step import simulate_batch_step
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
    dev = torch.device("cuda")
    _kernels.load_libraries()
    for name, info in _kernels.build_info.items():
        log(f"[2 build] {name} -> {info['path']} in {info['seconds']:.2f} s (cached={info['cached']})")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                log("    " + line.strip())
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=args.duration, device=dev)
    blocks_per_sm = _kernels.kstep_blocks_per_sm(pem.cfg)
    kname = f"kstep<{pem.cfg.ncharge},{pem.cfg.neutral_groups}>"
    sass = kernel_sass(_kernels.build_info["kstep"]["path"],
                       f"kstep_kernelILi{pem.cfg.ncharge}ELi{pem.cfg.neutral_groups}E")
    n_levels = _kernels.kernel_params(pem.cfg).n_levels
    barriers, step_insns = step_loop_counts(sass, n_levels)
    opcodes = collections.Counter(op.split(".")[0] for _, op, _ in sass)
    log(f"[2 build] {kname} at {fs.lanes_for(pem.cfg)} threads: {blocks_per_sm} blocks per SM; "
        f"in its SASS, per step ({n_levels} PCR levels): {barriers} block barriers, {step_insns} "
        f"instructions a warp issues (static, both sides of each branch); {len(sass)} instructions "
        f"in all: " + ", ".join(f"{k} {n}" for k, n in opcodes.most_common(12))
        + f" ({time.perf_counter() - t0:.2f} s)")

    # ---- 3. kernel vs plain version on the card, at the main path's shapes
    t0 = time.perf_counter()
    batch = 1024
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
    ms = cuda_ms(lambda: launch(fs.kstep), 20, lead=True)
    plain_ms = cuda_ms(lambda: launch(fs.kstep_plain), 1)
    ops1 = count_ops(lambda: fs.kstep_plain(state, prof, sacc, consts, 0, 1, pem.cfg, physics))
    ops2 = count_ops(lambda: fs.kstep_plain(state, prof, sacc, consts, 0, 2, pem.cfg, physics))
    ops = (ops1 - (ops2 - ops1)) + K * (ops2 - ops1)
    # what the kernel moves: state and profile sums read and written; of each
    # sample's 128 accumulator slots the 8 it reads and writes (no trace lanes
    # here), of its 128 scalar slots the 8 it reads (P_DV .. P_LDT); the lane
    # constants and the rate coefficients read
    n_bytes = 4 * (2 * (state.numel() + prof.numel()) + 2 * batch * (fs.A_ICIR + 1)
                   + consts["nu_anom"].numel() + consts["omega_ce"].numel()
                   + batch * fs.P_ICIR + _kernels.rate_coefficients(pem.cfg).size)
    ops_ms, bytes_ms = ops / H100_F32_FLOPS * 1e3, n_bytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    lanes = batch * fs.lanes_for(pem.cfg)
    log(f"[6 timing] kstep B={batch} K={K}: {ms:.3f} ms/launch ({ms / K * 1e3:.2f} us/step, "
        f"{ms / bound_ms:.2f}x the bound), plain {plain_ms:.1f} ms; {(ops2 - ops1) / lanes:.0f} ops per "
        f"lane-step, {ops:.3e} ops and {n_bytes:.3e} bytes per launch -> bound {bound_ms:.4f} ms "
        f"(ops {ops_ms:.4f}, bytes {bytes_ms:.4f}); {barriers} block barriers per step, "
        f"{blocks_per_sm} blocks per SM")
    # the issue-rate estimate: the busiest SM's warps each issue the step's
    # static instructions, over its 4 schedulers at one instruction a clock
    clocks = sm_clock_under_load(lambda: launch(fs.kstep), 2000)
    sm_mhz = sorted(clocks)[len(clocks) // 2] if clocks else None
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    warps_per_sm = math.ceil(batch / n_sm) * fs.lanes_for(pem.cfg) // 32
    issue_us = warps_per_sm * step_insns / 4 / sm_mhz if sm_mhz else None
    log(f"[6 timing] SM clock under load {clocks} MHz; {n_sm} SMs, {warps_per_sm} warps on the "
        f"busiest, {step_insns} static instructions a warp-step -> issue-limited estimate "
        + (f"{issue_us:.2f} us/step" if issue_us else "not measured (no read while busy)")
        + f" against {ms / K * 1e3:.2f} measured ({time.perf_counter() - t0:.2f} s)")

    kstep_ms, kstep_plain_ms = ms, plain_ms
    kstep_bound = (bound_ms, "operations" if ops_ms >= bytes_ms else "bytes")
    del params, consts, state, prof, sacc

    # ---- 7. the K-step kernel's variants vs the plain version: B = 1024, fidelity (2,2)
    t0 = time.perf_counter()
    variant_err = {}
    for label, variant in (("trace", {"num_save": 1000}), ("two_group", {"neutral_groups": 2})):
        vcfg = dataclasses.replace(pem.cfg, average_start_time=0.0, **variant)
        params, _ = _coupled_pre(default_coupled_inputs(batch, torch.Generator().manual_seed(8),
                                                        spread=0.08, device=dev), vcfg)
        consts, state0, prof0, sacc0 = fs.init_carry(params, pem.base_B, vcfg)
        outs = {}
        for block in (fs.kstep, fs.kstep_plain):
            s_, p_, a_ = state0.clone(), prof0.clone(), sacc0.clone()
            block(s_, p_, a_, consts, 0, K, vcfg, fs.Physics(vcfg))
            outs[block] = (s_, p_, a_)
        torch.cuda.synchronize()
        (ks, kp, ka), (ps, pp, pa) = outs[fs.kstep], outs[fs.kstep_plain]
        slots = list(range(fs.A_ICIR + 1))
        if vcfg.num_save:
            slots += list(range(fs.A_TRACE0, fs.A_TRACE0 + K))
        pairs = [(ks[j], ps[j]) for j in range(ks.shape[0])] + [(kp[j], pp[j]) for j in range(kp.shape[0])]
        pairs += [(ka[:, j], pa[:, j]) for j in slots]
        assert all(bool(torch.isfinite(k).all()) for k, _ in pairs), f"{label}: kernel output not finite"
        variant_err[label] = max(scaled_err(k, p) for k, p in pairs)
        log(f"[7 variants] {label}: 1 launch (K={K}) vs {K} plain steps, B={batch}, {ks.shape[0]} state "
            f"arrays, {len(pairs)} arrays in all: max scaled error {variant_err[label]:.3e} "
            f"(tolerance {STATE_RTOL:g})")
        assert variant_err[label] < STATE_RTOL, (label, variant_err[label])
        del params, consts, state0, prof0, sacc0, outs, ks, kp, ka, ps, pp, pa, pairs
    log(f"[7 variants] done ({time.perf_counter() - t0:.2f} s)")

    # ---- 8. the one-step kernel vs its plain version: one step at B = 1024
    t0 = time.perf_counter()
    params, _ = _coupled_pre(default_coupled_inputs(batch, torch.Generator().manual_seed(9),
                                                    spread=0.08, device=dev), pem.cfg)
    consts, state0, prof0, sacc0 = fs.init_carry(params, pem.base_B, pem.cfg)
    fs.kstep(state0, prof0, sacc0, consts, 0, K, pem.cfg)  # leave the smooth initial state
    consts["scalars"][:, fs.P_ICIR] = sacc0[:, fs.A_ICIR]
    extras0 = torch.zeros((5,) + tuple(state0.shape[1:]), device=dev)
    ks, kx, ps, px = state0.clone(), extras0.clone(), state0.clone(), extras0.clone()
    fs.step(ks, kx, consts, pem.cfg)
    fs.step_plain(ps, px, consts, pem.cfg, physics)
    torch.cuda.synchronize()
    pairs = [(ks[j], ps[j]) for j in range(ks.shape[0])] + [(kx[j], px[j]) for j in range(5)]
    assert all(bool(torch.isfinite(k).all()) for k, _ in pairs), "step kernel output not finite"
    step_err = max(scaled_err(k, p) for k, p in pairs)
    step_abs = max(float((k - p).abs().max()) for k, p in pairs)
    log(f"[8 step parity] 1 step, B={batch}: max scaled error {step_err:.3e} (tolerance "
        f"{STATE_RTOL:g}), max absolute error {step_abs:.3e} over {len(pairs)} arrays "
        f"({time.perf_counter() - t0:.2f} s)")
    assert step_err < STATE_RTOL

    # ---- 9. the wrapper path: hallthruster_jl, pem_v0 SPT-100 component, B = 1024
    t0 = time.perf_counter()
    comp_file = Path(thruster.__file__).parents[2] / "configs" / "pem_v0_SPT-100_thruster.json"
    comp = json.loads(comp_file.read_text())
    simulation = dict(comp["simulation"], duration=WRAPPER_DURATION)
    postprocess = dict(comp["postprocess"], average_start_time=0.5 * WRAPPER_DURATION)
    tree_kw = dict(thruster=comp["thruster"], config=comp["config"], simulation=simulation,
                   postprocess=postprocess, model_fidelity=tuple(comp["model_fidelity"]))
    kw = dict(tree_kw, device=dev)

    def thruster_inputs(seed):
        x = default_coupled_inputs(batch, torch.Generator().manual_seed(seed), spread=0.08, device=dev)
        v_cc = cathode_coupling({k: x[k] for k in ("P_b", "V_a", "T_e", "V_vac", "Pstar", "P_T")})["V_cc"]
        return dict({k: v for k, v in x.items() if k in thruster.PEM_TO_JULIA}, V_cc=v_cc)

    inp = thruster_inputs(42)
    tree = thruster.format_input_tree(inp, thruster.PEM_TO_JULIA, **tree_kw)
    wcfg, wparams, wbase_B = thruster._tree_to_solver_inputs(tree, dev)
    _kernels.reset_counts()
    out = thruster.hallthruster_jl(inp, **kw)
    torch.cuda.synchronize()
    walls = []
    for trial in range(2):
        inp = thruster_inputs(100 + trial)
        t1 = time.perf_counter()
        out = thruster.hallthruster_jl(inp, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wrapper_launches = dict(_kernels.launch_counts)
    n_launch_w = math.ceil(wcfg.num_steps / fs.INNER_STEPS)
    ok = torch.isfinite(out["T"])
    n_ok = int(ok.sum())
    trace = out["discharge_current_trace"]
    wall = min(walls)
    log(f"[9 wrapper path] hallthruster_jl, fidelity {comp['model_fidelity']}, {wcfg.num_cells} cells, "
        f"{wcfg.ncharge} charge states, adaptive dt {wcfg.dt:.4e} s, {wcfg.num_steps} steps x B={batch}, "
        f"num_save {wcfg.num_save}, cycle average: walls {walls[0]:.3f} / {walls[1]:.3f} s, "
        f"{wall / wcfg.num_steps * 1e6:.2f} us/step, finite {n_ok}/{batch}, "
        f"mean T {float(out['T'][ok].mean()):.5f} N, mean I_d {float(out['I_d'][ok].mean()):.4f} A, "
        f"kstep launches {wrapper_launches['kstep']} ({time.perf_counter() - t0:.2f} s)")
    wrapper_rate = batch * wcfg.duration * 1e3 / wall
    log(f"[9 wrapper path] {wrapper_rate:.2f} sim-ms/s")
    raw = out["thruster_output"]["output"]["average"]
    i_cap = 1.5 * wcfg.ncharge * FUNDAMENTAL_CHARGE * inp["mdot_a"] / wcfg.mi
    med = lambda v: float(v.nanmedian())
    log(f"[9 wrapper path] raw averages before the guards (medians over the batch): T "
        f"{med(raw['thrust']):.5f} N, I_d {med(raw['discharge_current']):.4f} A, I_B0 "
        f"{med(raw['ion_current']):.4f} A against a cap of {med(i_cap):.4f} A, mass efficiency "
        f"{med(raw['mass_eff']):.4f}; rows over the I_B0 cap {int((raw['ion_current'] > i_cap).sum())}")
    assert wrapper_launches["kstep"] == 3 * n_launch_w and wrapper_launches["step"] == 0, wrapper_launches
    assert n_ok >= batch - 10, n_ok
    assert trace.shape == (batch, 1000) and bool(torch.isfinite(trace[ok]).all())
    assert out["u_ion"].shape == (batch, wcfg.nc) and out["model_cost"].shape == (batch,)
    del out, raw, trace, inp
    wrapper_ms = {}
    for label, c in (("trace", wcfg), ("no trace", dataclasses.replace(wcfg, num_save=0))):
        carry = fs.init_carry(wparams, wbase_B, c)
        launch_w = lambda: fs.kstep(carry[1], carry[2], carry[3], carry[0], 0, K, c)
        launch_w()
        wrapper_ms[label] = cuda_ms(launch_w, 20, lead=True)
    log(f"[9 wrapper path] kstep on this config from its initial state, B={batch} K={K}: "
        f"{wrapper_ms['trace']:.3f} ms/launch with the trace lanes, {wrapper_ms['no trace']:.3f} "
        f"without (main path config: {kstep_ms:.3f})")
    del carry, wparams

    # ---- 10. the one-step driver vs the K-step driver: B = 1024, 914 steps
    t0 = time.perf_counter()
    small = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=2e-6, device=dev)
    params, _ = _coupled_pre(default_coupled_inputs(batch, torch.Generator().manual_seed(10),
                                                    spread=0.08, device=dev), small.cfg)
    _kernels.reset_counts()
    got = simulate_batch_step(params, small.base_B, small.cfg)
    torch.cuda.synchronize()
    step_launches = dict(_kernels.launch_counts)
    ref = fs.simulate_batch_multi(params, small.base_B, small.cfg)
    torch.cuda.synchronize()
    assert step_launches["step"] == small.cfg.num_steps and step_launches["kstep"] == 0, step_launches
    assert torch.equal(torch.isfinite(got["thrust"]), torch.isfinite(ref["thrust"]))
    ok = torch.isfinite(ref["thrust"])
    qoi_err = max(float(((got[k] - ref[k]).abs() / ref[k].abs())[ok].max())
                  for k in ("thrust", "discharge_current", "ion_current"))
    log(f"[10 one-step driver] B={batch}, {small.cfg.num_steps} steps, {step_launches['step']} step "
        f"launches: T/I_d/I_B0 vs the K-step driver max relative error {qoi_err:.3e} (tolerance "
        f"{QOI_RTOL:g}), finite {int(ok.sum())}/{batch} ({time.perf_counter() - t0:.2f} s)")
    assert qoi_err < QOI_RTOL and int(ok.sum()) > 0
    del got, ref

    # ---- 11. the one-step kernel's time, its plain version's and its bound, B = 1024
    t0 = time.perf_counter()
    state, extras = state0.clone(), extras0.clone()
    fs.step(state, extras, consts, pem.cfg)
    step_ms = cuda_ms(lambda: fs.step(state, extras, consts, pem.cfg), 50, lead=True)
    step_paced_ms = cuda_ms(lambda: fs.step(state, extras, consts, pem.cfg), 50)
    step_plain_ms = cuda_ms(lambda: fs.step_plain(state, extras, consts, pem.cfg, physics), 3)
    step_ops = count_ops(lambda: fs.step_plain(state, extras, consts, pem.cfg, physics))
    # state read and written, the 5 output arrays written, the lane constants,
    # of each sample's 128 scalar slots the 9 it reads (P_DV .. P_ICIR), and the
    # rate coefficients read
    step_bytes = 4 * (2 * state.numel() + extras.numel() + consts["nu_anom"].numel()
                      + consts["omega_ce"].numel() + batch * (fs.P_ICIR + 1)
                      + _kernels.rate_coefficients(pem.cfg).size)
    s_ops_ms, s_bytes_ms = step_ops / H100_F32_FLOPS * 1e3, step_bytes / H100_BYTES_PER_S * 1e3
    log(f"[11 step timing] step B={batch}: {step_ms * 1e3:.2f} us/launch on the card "
        f"({step_paced_ms * 1e3:.2f} us/launch at the host's launch pace), plain {step_plain_ms:.2f} ms; "
        f"{step_ops:.3e} ops and {step_bytes:.3e} bytes per launch -> bound "
        f"{max(s_ops_ms, s_bytes_ms) * 1e3:.2f} us (ops {s_ops_ms * 1e3:.2f}, bytes {s_bytes_ms * 1e3:.2f}) "
        f"({time.perf_counter() - t0:.2f} s)")

    kernels = [{
        "name": "kstep", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches["kstep"], "launches_wrapper_path": wrapper_launches["kstep"],
        "max_abs_err": max_abs, "max_scaled_err": max_err,
        "max_scaled_err_trace": variant_err["trace"], "max_scaled_err_two_group": variant_err["two_group"],
        "scaled_err_tolerance": STATE_RTOL, "ms": kstep_ms, "plain_ms": kstep_plain_ms,
        "bound_ms": kstep_bound[0], "bound_by": kstep_bound[1], "library_ms": None,
        "blocks_per_sm": blocks_per_sm, "barriers_per_step": barriers, "sass_instructions": len(sass),
        "sass_instructions_per_step": step_insns, "sm_clock_mhz": sm_mhz, "issue_us_per_step": issue_us,
    }, {
        "name": "step", "route": "cuda", "source": STEP_SOURCE, "replaces": STEP_REPLACES,
        "launches": step_launches["step"], "max_abs_err": step_abs, "max_scaled_err": step_err,
        "scaled_err_tolerance": STATE_RTOL, "ms": step_ms, "host_paced_ms": step_paced_ms,
        "plain_ms": step_plain_ms,
        "bound_ms": max(s_ops_ms, s_bytes_ms),
        "bound_by": "operations" if s_ops_ms >= s_bytes_ms else "bytes",
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
