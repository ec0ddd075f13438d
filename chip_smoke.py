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
   component (of ``configs/pem_v0_SPT-100.json``) at fidelity (2,2),
   B = 1024, ``num_save`` 1000 and the cycle average, cut to ``WRAPPER_DURATION``
   (5e-4 s, the bench length); one warm run and two timed runs, the
   launch count checked, the raw averages the failure guards judge; then the
   kernel's time per launch on this config, with the trace lanes and without;
10. the one-step driver against the K-step driver: B = 1024, 914 steps;
11. the one-step kernel's time per launch, its plain version's and its bound;
12. the lax solver (fidelity (2,2), B = 8, 200 steps) on the card against the
    same code on the host CPU: in float64, the config's own precision, which
    routes it to the lax solver, and in float32 through ``solver`` directly;
13. the full-width lax path: ``CoupledPEM(model_fidelity=(4,2))`` (300 cells + 2
    ghosts, 3 charge states) at B = 1024 for 2,000 steps, in one segment and in
    500-step chunks (equal outputs), timed, and the card's busy time a step
    from a ``torch.profiler`` trace of 20 of its steps; then float64 at
    fidelity (2,2), B = 1024, 500 steps, timed;
14. the System path: the pem_v0 SPT-100 JSON configuration, its Thruster cut to
    ``WRAPPER_DURATION``, ``sample_inputs(256)`` and ``predict(use_model="best")``
    through the K-step kernel, held equal to a direct ``hallthruster_jl`` call;
15. the surrogate path on ``configs/pem_v0_SPT-100_compression.json`` (the r5
    campaign's configuration with its compression maps), the Thruster cut to
    ``WRAPPER_DURATION``: (a) ``generate_training_data`` labels ``SURR_SAMPLES``
    prior samples in chunks of ``SURR_CHUNK`` through the K-step kernel; (b) an
    ``MLPSurrogate`` at the r5 width (4 x 512, 8 members) trains
    ``SURR_STEPS`` steps at batch ``SURR_BATCH`` on the card, TF32 off, its ms a
    step beside the operations bound; (c) ``System.predict(use_model=None)`` on
    ``SURR_PREDICT`` fresh samples on the card against the same state on the CPU;
    (d) ``save_to_file`` and ``load_from_file`` predict bit for bit alike; (e)
    ``fit`` (MISC, ``SURR_MISC_ITERS`` iterations) through the K-step kernel, then
    ``as_torch_fn(training=True)`` on the card against the host ``predict``;
16. the UQ path: (a) the bundled spt100 data through the port's loaders (23
    conditions); (b) the r5 campaign's solver-verified posterior predictive
    (``data/r5_posterior_predictive.npz``: 64 posterior draws x 23 conditions)
    through ``monte_carlo.run_experimental_comparison`` with the true model
    (``configs/pem_v0_SPT-100_compression.json``, the Thruster at its own 2e-3 s)
    and the K-step kernel, each rel-L2 against the data held to
    ``UQ_PREDICTIVE_GATE`` x r5's and each per-condition median to r5's within
    ``UQ_MEDIAN_GAP_TOL``, and the carry of its launch ``UQ_PARITY_LAUNCH``
    (B = 1,472) through one kernel launch against the plain version; (c) the
    batched device posterior on phase 15's saved system (17 parameters, V_cc, T,
    I_d, u_ion, j_ion) on the card against the CPU, each value within
    ``UQ_POSTERIOR_TOL`` of its own, then ``mcmc.main`` with the stretch sampler (``UQ_STRETCH_WALKERS``
    x ``UQ_STRETCH_ITERS``) and with DRAM (``UQ_DRAM_WALKERS`` x
    ``UQ_DRAM_ITERS``), every log-posterior call on the whole batch, the
    ``.npz`` chain read back equal; (d) ``sobol_sa`` over the 18 calibration and
    nuisance inputs, ``UQ_SOBOL_N`` x 20 rows in one batch on the card (timed as
    the least of ``UQ_SOBOL_TIMED_CALLS`` calls after a warm one), and the card
    against the CPU at ``UQ_SOBOL_CHECK_N``;
17. the multi-device path on phase 4's inputs (B = 1024) and outputs: (a)
    ``BatchExecutor(make_mesh())`` over every card of the machine runs
    ``CoupledPEM``; (b) ``simulate_batch_sharded`` on ``Mesh([cuda:0, cuda:0])``,
    two shards on one card, then the plume; (c) two processes on the card
    (``parallel.distributed.initialize``, gloo on a free localhost port), each
    ``process_local_batch`` of half the rows, then ``gather_to_host``: each
    equal to phase 4 bit for bit, with ``kstep`` launched once per shard and
    launch; (d) the host's µs per ``kstep`` launch with 1 and 2 threads
    enqueuing (``PARALLEL_HOST_LAUNCHES`` each);
18. the workflow scripts of ``hallthrusterpem_tpu_torch/scripts`` on the card:
    (a) ``install_solver`` (the build, warm here, and a smoke run at fidelities
    (0,0), (1,1), (2,2)), then ``kstep<1,1>`` and ``kstep<2,1>`` (fidelities
    (0,0) and (1,1)) one launch each against the plain version from one carry
    at B = ``WORKFLOW_BATCH``, timed beside their bounds; (b)
    ``validate_solver`` at its own settings (100 cells, 1 charge state, 6e-4 s,
    120,000 steps through ``kstep<1,1>`` at B = 10) with its trend asserts, and
    one launch at that shape against the plain version; (c) ``gen_data`` on
    ``configs/pem_v0_SPT-100.json`` (the Thruster cut to ``WRAPPER_DURATION``,
    ``WORKFLOW_GEN`` samples) and ``fit_surr --surrogate mlp`` at the r5 width
    (``WORKFLOW_MLP``), its test rel-L2 per QoI; (d) ``surr_report`` on the r5
    trained ensemble and test set (``runs/r5/surr``), each rel-L2 within
    ``WORKFLOW_REPORT_TOL`` of r5's ``report.json``; (e) ``debug`` over
    ``make_mesh()``; (f) ``BatchExecutor(Mesh([cuda:0, cuda:0])).run`` of
    ``hallthruster_jl`` on phase 9's inputs at ``WORKFLOW_SHARDED_DURATION``,
    bit for bit against the unsharded call.

It prints a ``{"lax": {...}}`` line (phases 12-14), a ``{"surrogate": {...}}``
line (phase 15), a ``{"uq": {...}}`` line (phase 16), a ``{"parallel": {...}}``
line (phase 17), a ``{"workflow": {...}}`` line (phase 18), a ``{"kernels": [...]}``
line (``kstep<3,1>``, ``kstep<1,1>``, ``kstep<2,1>``, ``step``), the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; without
a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import pickle
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
# the lax solver (phases 12-13): batch and steps compared card against host CPU,
# their bound per dtype; batch and steps of the full-width fidelity (4,2) run,
# its chunk, and the steps of its segment traced by torch.profiler; steps of the
# float64 run at fidelity (2,2)
LAX_PARITY_BATCH = 8
LAX_PARITY_STEPS = 200
LAX_TOL = {"float32": 1e-4, "float64": 1e-10}
LAX_BATCH = 1024
LAX_WIDE_STEPS = 2000
LAX_CHUNK = 500
LAX_TRACE_STEPS = 20
LAX_F64_STEPS = 500
SYSTEM_BATCH = 256  # phase 14
# phase 15: samples labelled and their chunk; the MLP's width, members, steps and
# batch (the r5 campaign's, runs/r5/surr); fresh samples predicted; MISC
# iterations, their surplus points, the samples of the card-vs-host check; the
# bound on scaled errors (float32 on the card and on the CPU)
SURR_SAMPLES = 2048
SURR_CHUNK = 1024
SURR_HIDDEN = (512,) * 4
SURR_ENSEMBLE = 8
SURR_STEPS = 500
SURR_BATCH = 2048
SURR_PREDICT = 4096
SURR_MISC_ITERS = 3
SURR_MISC_REFINE = 64
SURR_MISC_CHECK = 512
SURR_TOL = 1e-5
# phase 16: the gate on each rel-L2 against the data of the r5 posterior
# predictive (data/r5_posterior_predictive.npz), as a factor range of r5's; the
# bound on the largest relative gap of its per-condition medians to r5's; the
# predictive's K-step launch whose carry is held against the plain version at
# its batch; thetas of the card-vs-CPU posterior check and its bound (relative,
# on each value); the
# stretch and DRAM runs (walkers, iterations); Sobol' samples on the card, at the
# card-vs-CPU check, its bound on S1 and ST, and the pressure
UQ_PREDICTIVE_GATE = (0.75, 1.25)
UQ_MEDIAN_GAP_TOL = 1e-2
UQ_PARITY_LAUNCH = 10_000
UQ_CHECK_THETAS = 64
UQ_POSTERIOR_TOL = 1e-4
UQ_STRETCH_WALKERS = 64
UQ_STRETCH_ITERS = 1000
UQ_DRAM_WALKERS = 8
UQ_DRAM_ITERS = 500
UQ_SOBOL_N = 5000
UQ_SOBOL_CHECK_N = 512
UQ_SOBOL_TOL = 1e-4
UQ_SOBOL_TIMED_CALLS = 3
UQ_SOBOL_PB = 1e-5
UQ_QOIS = ["V_cc", "T", "I_d", "u_ion", "j_ion"]
# phase 17: launches each host thread enqueues, the seconds a child process may take
PARALLEL_HOST_LAUNCHES = 200
PARALLEL_CHILD_TIMEOUT = 300
# phase 18: the batch of the low-fidelity kernels' parity launch and timing; the
# pipeline's compression and test samples; fit_surr's MLP (samples labelled,
# steps, width, members: the r5 width, far fewer samples and steps); the bound on
# surr_report's rel-L2 against runs/r5/surr/report.json (4 decimals); the
# simulated seconds of the sharded wrapper's bit-equality check
WORKFLOW_BATCH = 1024
WORKFLOW_GEN = (256, 128)
WORKFLOW_MLP = {"samples": 1024, "steps": 300, "hidden": (512,) * 4, "ensemble": 8}
WORKFLOW_REPORT_TOL = 5e-4
WORKFLOW_SHARDED_DURATION = 5e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def scaled_err(a, b) -> float:
    """max |a - b| / max |b|: the error in units of the array's own scale."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def carry_errs(fs, got, ref) -> tuple:
    """(max scaled error, max absolute error, arrays compared) of one K-step
    carry ``(state, prof, sacc)`` against another: each state and profile row,
    and the accumulator slots up to the circuit current."""
    (ks, kp, ka), (ps, pp, pa) = got, ref
    pairs = [(ks[j], ps[j]) for j in range(ks.shape[0])] + [(kp[j], pp[j]) for j in range(kp.shape[0])]
    pairs += [(ka[:, j], pa[:, j]) for j in range(fs.A_ICIR + 1)]
    return (max(scaled_err(k, p) for k, p in pairs), max(float((k - p).abs().max()) for k, p in pairs),
            len(pairs))


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


def count_dispatches(fn) -> int:
    """aten operators ``fn`` dispatches (views and copies included): on the card
    about one launch each, the host's work per call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Counter.n += 1
            return func(*args, **(kwargs or {}))

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


def kstep_bound(fs, kernels, carry, cfg, physics) -> dict:
    """The least time of one K = 50 launch from ``carry`` ``(consts, state,
    prof, sacc)``: the larger of its operations (counted on the plain version:
    one step's and the set-up's, from 1 and 2 steps) over the card's float32
    rate and its bytes over the memory rate. ``bytes``: state and profile sums
    read and written; of each sample's 128 accumulator slots the ones up to the
    circuit current read and written (no trace lanes), of its 128 scalar slots
    the ones before it read; the lane constants and the rate coefficients read.
    The plain steps advance ``carry``."""
    consts, state, prof, sacc = carry
    K, batch = fs.INNER_STEPS, sacc.shape[0]
    ops1 = count_ops(lambda: fs.kstep_plain(state, prof, sacc, consts, 0, 1, cfg, physics))
    ops2 = count_ops(lambda: fs.kstep_plain(state, prof, sacc, consts, 0, 2, cfg, physics))
    ops = (ops1 - (ops2 - ops1)) + K * (ops2 - ops1)
    n_bytes = 4 * (2 * (state.numel() + prof.numel()) + 2 * batch * (fs.A_ICIR + 1)
                   + consts["nu_anom"].numel() + consts["omega_ce"].numel()
                   + batch * fs.P_ICIR + kernels.rate_coefficients(cfg).size)
    ops_ms, bytes_ms = ops / H100_F32_FLOPS * 1e3, n_bytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": ops, "bytes": n_bytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms, "ops_per_step": ops2 - ops1}


def lax_card_vs_cpu(cfg, params, base_B, n_steps: int) -> float:
    """Phase 12 for one config: ``n_steps`` lax-solver steps on the card and on
    the host CPU from the same inputs; the largest scaled error over the state
    and the running sums (the failure flags must agree)."""
    import torch

    from hallthrusterpem_tpu_torch.models.thruster import solver

    carries = []
    for p, b in ((params, base_B), ({k: v.cpu() for k, v in params.items()}, base_B.cpu())):
        carries.append(solver._segment_batch(p, b, solver._init_batch(p, b, cfg), cfg, n_steps))
    (card_state, card_acc, _, card_failed), (cpu_state, cpu_acc, _, cpu_failed) = carries
    assert torch.equal(card_failed.cpu(), cpu_failed), "failure flags differ"
    pairs = list(zip(card_state, cpu_state)) + [(card_acc[k], cpu_acc[k]) for k in cpu_acc]
    for got, _ in pairs:
        assert got.device.type == params["V_d"].device.type and got.dtype == solver._dtype(cfg)
    return max(scaled_err(got.cpu(), ref) for got, ref in pairs)


def device_busy(fn) -> tuple:
    """Run ``fn`` under ``torch.profiler`` and read the card's activity from
    the trace: (busy ms, the union of the kernel, copy and set intervals on the
    card; host wall ms of ``fn`` and a card sync, traced; card events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us * 1e-3, wall_ms, len(spans)


def lax_phases(kstep_us: float) -> dict:
    """Phases 12 and 13: the lax solver on the card against the host CPU, then
    the full-width fidelity (4,2) ``CoupledPEM`` (monolithic and chunked, and a
    traced segment of it) and the float64 fidelity (2,2) one, timed. Returns the
    ``{"lax": ...}`` record."""
    import torch

    import hallthrusterpem_tpu_torch.models.thruster as thruster
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import solver
    from hallthrusterpem_tpu_torch.pem import CoupledPEM, _coupled_pre, default_coupled_inputs

    dev, sync, batch = torch.device("cuda"), torch.cuda.synchronize, LAX_BATCH
    record = {}
    # ---- 12. lax on the card against lax on the host CPU: fidelity (2,2), B = 8
    t0 = time.perf_counter()
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=2e-5, device=dev)
    inp = default_coupled_inputs(LAX_PARITY_BATCH, torch.Generator().manual_seed(12), spread=0.08, device=dev)
    for dtype in ("float32", "float64"):
        cfg = dataclasses.replace(pem.cfg, dtype=dtype, average_start_time=0.0,
                                  duration=LAX_PARITY_STEPS * pem.cfg.dt)
        assert thruster.uses_lax_solver(cfg) == (dtype == "float64")
        params, _ = _coupled_pre(inp, cfg)
        err = lax_card_vs_cpu(cfg, params, pem.base_B, LAX_PARITY_STEPS)
        record[f"card_vs_cpu_scaled_err_{dtype}"] = err
        log(f"[12 lax parity] {dtype}, {cfg.num_cells} cells, {cfg.ncharge} charge states, "
            f"B={LAX_PARITY_BATCH}, {LAX_PARITY_STEPS} steps: card vs host CPU max scaled error {err:.3e} "
            f"(tolerance {LAX_TOL[dtype]:g})")
        assert err < LAX_TOL[dtype], (dtype, err)
    log(f"[12 lax parity] done ({time.perf_counter() - t0:.2f} s)")

    # ---- 13. the full-width lax path: CoupledPEM at fidelity (4,2), B = 1024
    t0 = time.perf_counter()
    probe = CoupledPEM(thruster="SPT-100", model_fidelity=(4, 2), duration=1e-6, device=dev)
    wide = CoupledPEM(thruster="SPT-100", model_fidelity=(4, 2), duration=LAX_WIDE_STEPS * probe.cfg.dt,
                      device=dev)
    assert thruster.uses_lax_solver(wide.cfg) and wide.cfg.nc == 302 and wide.cfg.num_steps == LAX_WIDE_STEPS
    inp = default_coupled_inputs(batch, torch.Generator().manual_seed(13), spread=0.08, device=dev)
    _kernels.reset_counts()
    runs = {}
    for label, chunk_steps in (("monolithic", None), ("chunked", LAX_CHUNK)):
        t1 = time.perf_counter()
        runs[label] = wide(inp, chunk_steps=chunk_steps)
        sync()
        runs[label + "_s"] = time.perf_counter() - t1
    assert _kernels.launch_counts == {"kstep": 0, "step": 0}, _kernels.launch_counts
    mono, chunked = runs["monolithic"], runs["chunked"]
    for k in mono:
        assert torch.equal(torch.nan_to_num(mono[k]), torch.nan_to_num(chunked[k])) and torch.equal(
            torch.isnan(mono[k]), torch.isnan(chunked[k])), f"chunked run differs in {k}"
    n_ok = int(torch.isfinite(mono["T"]).sum())
    # the rates use the faster run: the first one also grows the allocator's pool
    wall = min(runs["monolithic_s"], runs["chunked_s"])
    wide_rec = {"num_cells": wide.cfg.num_cells, "ncharge": wide.cfg.ncharge, "batch": batch,
                "duration_s": wide.cfg.duration, "steps": wide.cfg.num_steps, "wall_s": runs["monolithic_s"],
                "wall_chunked_s": runs["chunked_s"], "chunk_steps": LAX_CHUNK,
                "ms_per_step": wall / wide.cfg.num_steps * 1e3,
                "sim_ms_per_s": batch * wide.cfg.duration * 1e3 / wall, "finite": n_ok}
    record["fidelity_4_2_float32"] = wide_rec
    log(f"[13 lax wide] CoupledPEM fidelity (4,2): {wide.cfg.num_cells} cells + 2 ghosts, {wide.cfg.ncharge} "
        f"charge states, B={batch}, duration {wide.cfg.duration:.4e} s = {wide.cfg.num_steps} steps: wall "
        f"{runs['monolithic_s']:.3f} s monolithic, {runs['chunked_s']:.3f} s in {LAX_CHUNK}-step chunks (equal "
        f"outputs); at the faster: "
        f"{wide_rec['ms_per_step']:.3f} ms/step, {wide_rec['sim_ms_per_s']:.3f} sim-ms/s, finite {n_ok}/{batch} "
        f"(kstep at fidelity (2,2): {kstep_us:.2f} us/step)")
    assert n_ok >= batch - 10, n_ok
    del runs, mono, chunked
    t1 = time.perf_counter()
    pem64 = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=LAX_F64_STEPS * pem.cfg.dt,
                       device=dev)
    pem64.cfg = dataclasses.replace(pem64.cfg, dtype="float64")
    out = pem64(default_coupled_inputs(batch, torch.Generator().manual_seed(31), spread=0.08, device=dev))
    sync()
    wall = time.perf_counter() - t1
    for k in ("T", "I_d", "I_B0", "eta_c", "eta_m", "eta_v", "eta_a", "u_ion", "I_d_std"):
        assert out[k].dtype == torch.float64, (k, out[k].dtype)
    n_ok = int(torch.isfinite(out["T"]).sum())
    f64_rec = {"num_cells": pem64.cfg.num_cells, "ncharge": pem64.cfg.ncharge, "batch": batch,
               "duration_s": pem64.cfg.duration, "steps": pem64.cfg.num_steps, "wall_s": wall,
               "ms_per_step": wall / pem64.cfg.num_steps * 1e3,
               "sim_ms_per_s": batch * pem64.cfg.duration * 1e3 / wall, "finite": n_ok}
    record["fidelity_2_2_float64"] = f64_rec
    log(f"[13 lax float64] CoupledPEM fidelity (2,2) in float64, B={batch}, {pem64.cfg.num_steps} steps: wall "
        f"{wall:.3f} s, {f64_rec['ms_per_step']:.3f} ms/step, {f64_rec['sim_ms_per_s']:.3f} sim-ms/s, "
        f"finite {n_ok}/{batch}, outputs float64")
    assert n_ok >= batch - 10, n_ok
    # the card's busy time a step, from a torch.profiler trace of a segment of
    # the fidelity (4,2) run (its first steps, from the same inputs); after the
    # timed lax runs, so that no tracing cost can reach them
    params, _ = _coupled_pre(inp, wide.cfg)
    carry = solver._init_batch(params, wide.base_B, wide.cfg)
    sync()
    busy_ms, traced_ms, n_events = device_busy(
        lambda: solver._segment_batch(params, wide.base_B, carry, wide.cfg, LAX_TRACE_STEPS))
    assert n_events > 0, "the profiler recorded no activity on the card"
    wide_rec.update(trace_steps=LAX_TRACE_STEPS, trace_device_events=n_events,
                    device_ms_per_step=busy_ms / LAX_TRACE_STEPS,
                    traced_ms_per_step=traced_ms / LAX_TRACE_STEPS, device_busy_share=busy_ms / traced_ms)
    log(f"[13 lax wide] torch.profiler trace of {LAX_TRACE_STEPS} steps: {n_events} events on the card, busy "
        f"{wide_rec['device_ms_per_step']:.3f} ms/step of {wide_rec['traced_ms_per_step']:.3f} ms/step on the "
        f"host's clock while traced: busy share {wide_rec['device_busy_share']:.3f}")
    del params, carry
    log(f"[13 lax] done ({time.perf_counter() - t0:.2f} s)")
    record["kstep_us_per_step_fidelity_2_2"] = kstep_us
    return record


def system_phase() -> dict:
    """Phase 14: ``System.predict(use_model="best")`` on the pem_v0 SPT-100 JSON
    configuration (Cathode -> Thruster -> Plume), the Thruster cut to
    ``WRAPPER_DURATION``; its outputs against a direct ``hallthruster_jl`` call on
    the same inputs."""
    import torch

    import hallthrusterpem_tpu_torch.models.thruster as thruster
    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.models.thruster import _kernels

    dev, sync, batch, duration = torch.device("cuda"), torch.cuda.synchronize, SYSTEM_BATCH, WRAPPER_DURATION
    t0 = time.perf_counter()
    system = load_system("pem_v0_SPT-100.json", device=dev)
    comp = system["Thruster"]
    comp.model_kwargs["simulation"] = dict(comp.model_kwargs["simulation"], duration=duration)
    comp.model_kwargs["postprocess"] = dict(comp.model_kwargs["postprocess"], average_start_time=0.5 * duration)
    samples = system.sample_inputs(batch, generator=torch.Generator().manual_seed(14))
    _kernels.reset_counts()
    t1 = time.perf_counter()
    out = system.predict(samples, use_model="best")
    sync()
    wall = time.perf_counter() - t1
    launches = _kernels.launch_counts["kstep"]
    assert launches > 0, _kernels.launch_counts
    assert out["T"].device.type == dev.type and out["j_ion"].shape == (batch, 91)
    direct = thruster.hallthruster_jl({n: out[n] for n in comp.input_names()},
                                      model_fidelity=comp.model_fidelity, device=dev, **comp.model_kwargs)
    sync()
    for k in comp.output_names():
        assert torch.equal(torch.isnan(out[k]), torch.isnan(direct[k])) and torch.equal(
            torch.nan_to_num(out[k]), torch.nan_to_num(direct[k])), f"System output {k} differs"
    n_ok = int(torch.isfinite(out["T"]).sum())
    log(f"[14 System] pem_v0_SPT-100.json, Thruster duration {duration:g} s, B={batch}: "
        f"Cathode -> Thruster -> Plume in {wall:.3f} s, kstep launches {launches}, finite {n_ok}/{batch} "
        f"(the priors are wide: the guards reject rows outside the discharge's range); Thruster outputs equal "
        f"a direct hallthruster_jl call ({time.perf_counter() - t0:.2f} s)")
    return {"batch": batch, "wall_s": wall, "kstep_launches": launches, "finite": n_ok}


def surrogate_phase() -> dict:
    """Phase 15: the surrogates on the card, trained on data the K-step kernel
    labels; returns the ``{"surrogate": ...}`` record."""
    import numpy as np
    import torch

    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.core.system import System
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.surrogate.domain import failure_mask
    from hallthrusterpem_tpu_torch.surrogate.mlp import (
        EnsembleMLP, MLPSurrogate, generate_training_data, make_optimizer, train_step)

    dev, sync, config = torch.device("cuda"), torch.cuda.synchronize, "pem_v0_SPT-100_compression.json"
    t0 = time.perf_counter()
    build = Path("build") / "surrogate"
    build.mkdir(parents=True, exist_ok=True)
    cache = build / "pem_v0_SPT-100_mlp_train_data.pkl"
    cache.unlink(missing_ok=True)  # label anew: no resume from an earlier run
    system = load_system(config, device=dev)
    comp = system["Thruster"]
    comp.model_kwargs["simulation"] = dict(comp.model_kwargs["simulation"], duration=WRAPPER_DURATION)
    comp.model_kwargs["postprocess"] = dict(comp.model_kwargs["postprocess"],
                                            average_start_time=0.5 * WRAPPER_DURATION)
    rec: dict = {}

    # ---- (a) labelled data through the K-step kernel
    _kernels.reset_counts()
    t1 = time.perf_counter()
    samples, outputs = generate_training_data(system, SURR_SAMPLES, seed=15, chunk=SURR_CHUNK, cache_path=cache)
    sync()
    label_s = time.perf_counter() - t1
    launches = _kernels.launch_counts["kstep"]
    n_ok = int((~failure_mask(outputs, skip=set(samples))).sum())
    rec["label"] = {"samples": SURR_SAMPLES, "chunk": SURR_CHUNK, "wall_s": label_s, "kstep_launches": launches,
                    "finite_rows": n_ok, "rows_per_s": SURR_SAMPLES / label_s}
    log(f"[15a label] {SURR_SAMPLES} prior samples in chunks of {SURR_CHUNK}, Thruster {WRAPPER_DURATION:g} s: "
        f"{label_s:.3f} s ({SURR_SAMPLES / label_s:.1f} rows/s), kstep launches {launches}, finite rows "
        f"{n_ok}/{SURR_SAMPLES}")
    assert launches > 0, _kernels.launch_counts
    assert cache.exists() and n_ok > SURR_SAMPLES // 2, n_ok

    # ---- (b) the MLP ensemble at the r5 width, trained on the card with TF32 off
    assert not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest"
    surr = MLPSurrogate(system, hidden=SURR_HIDDEN, ensemble=SURR_ENSEMBLE, seed=15)
    t1 = time.perf_counter()
    info = surr.fit(samples, outputs, steps=SURR_STEPS, batch=SURR_BATCH, log_every=100)
    sync()
    fit_s = time.perf_counter() - t1
    assert not torch.backends.cuda.matmul.allow_tf32
    assert all(p.device.type == "cuda" for p in surr.net.parameters())
    # one step's time on the card (CUDA events, fixed minibatches), its
    # operations (the products: forward, weight gradients, input gradients past
    # the first layer; the elementwise passes add under 1%) and its bytes (the
    # parameters and both Adam moments read and written, the minibatch read)
    K, B = SURR_ENSEMBLE, SURR_BATCH
    sizes = [surr.n_in, *SURR_HIDDEN, surr.n_out + 1]
    macs = [a * b for a, b in zip(sizes[:-1], sizes[1:])]
    ops = 2 * K * B * (2 * sum(macs) + sum(macs[1:]))
    n_par = sum(p.numel() for p in surr.net.parameters())
    n_bytes = 4 * (6 * n_par + K * B * (surr.n_in + 2 * surr.n_out + 1))
    net = EnsembleMLP(surr.net.to_numpy()).to(dev)
    opt_state = make_optimizer(net, 2e-3, SURR_STEPS, 1e-5)
    g = torch.Generator().manual_seed(0)
    xb = torch.randn((K, B, surr.n_in), generator=g).to(dev)
    yb = torch.randn((K, B, surr.n_out), generator=g).to(dev)
    mb, fb = torch.ones_like(yb), torch.zeros((K, B), device=dev)
    step = lambda: train_step(net, opt_state, xb, yb, mb, fb)
    step()
    step_ms = cuda_ms(step, 20, lead=True)
    ops_ms, bytes_ms = ops / H100_F32_FLOPS * 1e3, n_bytes / H100_BYTES_PER_S * 1e3
    rec["train"] = {"hidden": list(SURR_HIDDEN), "ensemble": K, "steps": SURR_STEPS, "batch": B,
                    "n_in": surr.n_in, "n_out": surr.n_out, "params": n_par, "wall_s": fit_s,
                    "ms_per_step": step_ms, "ops_per_step": ops, "bytes_per_step": n_bytes,
                    "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                    "val_rmse": info["val_rmse"], "val_fail_acc": info["val_fail_acc"], "tf32": False}
    log(f"[15b train] MLPSurrogate {SURR_HIDDEN} x {K} members, {surr.n_in} inputs -> {surr.n_out} outputs + "
        f"fail logit, {n_par} parameters: fit of {SURR_STEPS} steps at batch {B} in {fit_s:.3f} s; "
        f"{step_ms:.3f} ms/step on the card (TF32 off), {ops:.3e} ops and {n_bytes:.3e} bytes a step -> bound "
        f"{max(ops_ms, bytes_ms):.3f} ms (ops at 67 TFLOP/s float32 {ops_ms:.3f}, bytes {bytes_ms:.4f}), "
        f"{step_ms / max(ops_ms, bytes_ms):.2f}x; val_rmse {info['val_rmse']:.4f}, "
        f"val_fail_acc {info['val_fail_acc']:.3f}")
    assert np.isfinite(info["val_rmse"])
    del net, opt_state, xb, yb, mb, fb

    # ---- (c) System.predict(use_model=None) on the card against the CPU
    system.system_surrogate = surr
    fresh = system.sample_inputs(SURR_PREDICT, generator=torch.Generator().manual_seed(151),
                                 use_pdf=["calibration", "nuisance"])
    out = system.predict(fresh)
    sync()
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        out = system.predict(fresh)
        sync()
        walls.append(time.perf_counter() - t1)
    cpu_sys = load_system(config, device="cpu")
    cpu_sys.system_surrogate = MLPSurrogate.from_state(surr.to_state(), cpu_sys)
    ref = cpu_sys.predict({k: v.cpu() for k, v in fresh.items()})
    names = [k for k in ref if k not in fresh]
    errs = {k: scaled_err(out[k].cpu().double(), ref[k].double()) for k in names}
    rec["predict"] = {"samples": SURR_PREDICT, "wall_s": min(walls), "per_s": SURR_PREDICT / min(walls),
                      "card_vs_cpu_max_scaled_err": max(errs.values())}
    log(f"[15c predict] System.predict(use_model=None), {SURR_PREDICT} samples: {min(walls) * 1e3:.3f} ms "
        f"({SURR_PREDICT / min(walls):.0f} predictions/s) on the card; card vs CPU max scaled error "
        f"{max(errs.values()):.3e} over {len(names)} outputs (tolerance {SURR_TOL:g}), worst "
        f"{max(errs, key=errs.get)}")
    assert all(out[k].device.type == "cuda" for k in names) and "sys_fail_prob" in names
    assert max(errs.values()) <= SURR_TOL, errs

    # ---- (d) state round trip: save_to_file -> load_from_file (with its sidecar)
    path = system.save_to_file("surrogate_trained.json", build)
    loaded = System.load_from_file(path, device=dev)
    again = loaded.predict(fresh)
    sync()
    assert loaded.system_surrogate is not None
    assert all(torch.equal(again[k], out[k]) for k in names), "reloaded predictions differ"
    rec["state_roundtrip_bit_equal"] = True
    log(f"[15d state] {path.name} + {path.name}.state.pkl "
        f"({(build / (path.name + '.state.pkl')).stat().st_size / 2**20:.1f} MiB): reloaded predictions equal "
        f"bit for bit")
    del loaded, again, cpu_sys

    # ---- (e) MISC sparse grids through the K-step kernel; card vs host
    system.system_surrogate = None
    evals0 = {c.name: dict(c.model_costs) for c in system.components}
    _kernels.reset_counts()
    t1 = time.perf_counter()
    history = system.fit(max_iter=SURR_MISC_ITERS, num_refine=SURR_MISC_REFINE, verbose=False)
    sync()
    misc_s = time.perf_counter() - t1
    misc_launches = _kernels.launch_counts["kstep"]
    thruster_evals = {str(a): n - evals0["Thruster"].get(a, (0, 0.0))[0]
                      for a, (n, _) in system["Thruster"].model_costs.items()
                      if n > evals0["Thruster"].get(a, (0, 0.0))[0]}
    hist = [{"component": h["component"], "alpha": list(h["alpha"]), "beta": list(h["beta"]),
             "error_indicator": h["error_indicator"], "num_evals": h["num_evals"]} for h in history]
    for h in hist:
        log(f"[15e MISC] activate {h['component']} alpha={tuple(h['alpha'])} beta={tuple(h['beta'])} "
            f"indicator {h['error_indicator']:.3e}, {h['num_evals']} evaluations")
    x = system.sample_inputs(SURR_MISC_CHECK, generator=torch.Generator().manual_seed(152),
                             use_pdf=["calibration", "nuisance"])
    host = system.predict(x, use_model=None, training=True)
    card = system.as_torch_fn(training=True)(x)
    sync()
    misc_names = [v.name for v in system.outputs()]
    misc_errs = {k: scaled_err(card[k].cpu().double(), host[k].cpu().double()) for k in misc_names}
    rec["misc"] = {"iterations": len(hist), "num_refine": SURR_MISC_REFINE, "wall_s": misc_s,
                   "kstep_launches": misc_launches, "thruster_evals": thruster_evals, "history": hist,
                   "card_vs_host_max_scaled_err": max(misc_errs.values())}
    log(f"[15e MISC] fit of {len(hist)} iterations in {misc_s:.3f} s: Thruster evaluations {thruster_evals}, "
        f"kstep launches {misc_launches}; as_torch_fn(training=True) on the card (float32) vs the host predict "
        f"(float64), {SURR_MISC_CHECK} samples: max scaled error {max(misc_errs.values()):.3e} (tolerance "
        f"{SURR_TOL:g}), worst {max(misc_errs, key=misc_errs.get)}")
    assert len(hist) == SURR_MISC_ITERS and misc_launches > 0, (hist, _kernels.launch_counts)
    assert all(card[k].device.type == "cuda" and card[k].dtype == torch.float32 for k in misc_names)
    assert max(misc_errs.values()) <= SURR_TOL, misc_errs
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[15 surrogate] done ({rec['wall_s']:.2f} s)")
    return rec


def uq_phase(trained: Path) -> dict:
    """Phase 16: the UQ path on the card; ``trained`` is phase 15's saved system.
    Returns the ``{"uq": ...}`` record."""
    import numpy as np
    import torch

    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.core.system import System
    from hallthrusterpem_tpu_torch import data
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.scripts.pem_v0 import mcmc, monte_carlo, sobol
    from hallthrusterpem_tpu_torch.scripts.pem_v0.dataset_util import load_experiment
    from hallthrusterpem_tpu_torch.uq import read_mcmc_chain, sobol_sa

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    t0 = time.perf_counter()
    build = Path("build") / "uq"
    build.mkdir(parents=True, exist_ok=True)
    rec: dict = {}

    # ---- (a) the bundled spt100 data through the port's loaders
    ops, obs, _, fields = load_experiment(["spt100"], UQ_QOIS)
    counts = {q: int(np.isfinite(obs[q]).sum()) for q in obs}
    counts.update({q: sum(s is not None for s in fields[q]) for q in fields})
    log(f"[16a data] spt100: {len(ops['P_b'])} operating conditions; conditions with data {counts}")
    assert len(ops["P_b"]) == 23 and counts["V_cc"] == 7 and counts["T"] == 17 and counts["I_d"] == 17, counts
    rec["data"] = {"conditions": len(ops["P_b"]), "with_data": counts}

    # ---- (b) the r5 solver-verified posterior predictive through the K-step kernel
    with np.load(Path(data.__file__).parent / "r5_posterior_predictive.npz") as f:
        r5 = {k: f[k] for k in f.files}
    system = load_system("pem_v0_SPT-100_compression.json", device=dev)
    sim = system["Thruster"].model_kwargs["simulation"]
    duration = float(sim["duration"])
    assert duration == float(r5["duration"]), (duration, r5["duration"])
    calib_names = [v.name for v in system.inputs() if v.category == "calibration"]
    assert calib_names == [str(n) for n in r5["calib_names"]], calib_names
    args = monte_carlo.parser.parse_args(["pem_v0_SPT-100_compression.json", "--data", "spt100",
                                          "--qois", "V_cc", "T", "I_d"])
    rows = len(r5["draws"]) * len(ops["P_b"])
    real_kstep, seen, carry = fs.kstep, [0], {}

    def capturing(state, prof, sacc, consts, i0, K, cfg, physics=None):
        # keep the carry going into one mid-run launch, to hold the kernel
        # against its plain version at this batch below
        seen[0] += 1
        if seen[0] == UQ_PARITY_LAUNCH:
            carry.update(args=(state.clone(), prof.clone(), sacc.clone(), consts, i0, K, cfg))
        real_kstep(state, prof, sacc, consts, i0, K, cfg, physics)

    fs.kstep = capturing
    try:
        _kernels.reset_counts()
        t1 = time.perf_counter()
        res = monte_carlo.run_experimental_comparison(system, args, None, calib_names, draws=r5["draws"],
                                                      sources=["model"])
        sync()
        wall = time.perf_counter() - t1
        launches = _kernels.launch_counts["kstep"]
    finally:
        fs.kstep = real_kstep
    pred = res["preds"]["model"]
    finite = int(torch.isfinite(pred["T"]).sum())
    pred_rec = {"rows": rows, "duration_s": duration, "wall_s": wall,
                "sim_ms_per_s": rows * duration * 1e3 / wall,
                "kstep_launches": launches, "finite_rows": finite, "rel_l2": {}, "r5_rel_l2": {},
                "median_max_rel_gap": {}}
    for i, q in enumerate(str(x) for x in r5["qois"]):
        got, ref = res["rel_l2"][q]["model"], float(r5["rel_l2_model"][i])
        mask = np.isfinite(r5[f"model_median_{q}"])
        gap = np.abs(res["median"][q]["model"][mask] / r5[f"model_median_{q}"][mask] - 1)
        pred_rec["rel_l2"][q], pred_rec["r5_rel_l2"][q] = got, ref
        pred_rec["median_max_rel_gap"][q] = float(np.max(gap))
        log(f"[16b predictive] {q}: rel-L2 vs data {got:.4e} (r5 {ref:.4e}, ratio {got / ref:.3f}, gate "
            f"{UQ_PREDICTIVE_GATE}); per-condition medians vs r5's: largest relative gap {np.max(gap):.3e}")
    log(f"[16b predictive] {rows} rows ({len(r5['draws'])} r5 posterior draws x {len(ops['P_b'])} "
        f"conditions), "
        f"Thruster {duration:g} s: "
        f"{wall:.3f} s ({rows * duration * 1e3 / wall:.2f} sim-ms/s), kstep launches {launches}, "
        f"finite rows {finite}/{rows}")
    assert launches >= UQ_PARITY_LAUNCH and "args" in carry, (launches, UQ_PARITY_LAUNCH)
    c_state, c_prof, c_sacc, c_consts, c_i0, c_K, c_cfg = carry.pop("args")
    outs = []
    for block, physics in ((real_kstep, None), (fs.kstep_plain, fs.Physics(c_cfg))):
        s_, p_, a_ = c_state.clone(), c_prof.clone(), c_sacc.clone()
        block(s_, p_, a_, c_consts, c_i0, c_K, c_cfg, physics)
        outs.append((s_, p_, a_))
    sync()
    p_err, p_abs, n_arrays = carry_errs(fs, *outs)
    log(f"[16b predictive] launch {UQ_PARITY_LAUNCH} (step {c_i0}, K={c_K}, B={c_state.shape[1]}) vs "
        f"{c_K} plain steps from its carry: max scaled error {p_err:.3e} (tolerance {STATE_RTOL:g}), "
        f"max absolute error {p_abs:.3e} over {n_arrays} arrays")
    pred_rec["kstep_vs_plain_scaled_err"] = p_err
    rec["predictive"] = pred_rec
    del carry, c_state, c_prof, c_sacc, c_consts, outs
    assert p_err < STATE_RTOL, p_err
    assert launches > 0 and finite >= rows // 2, (launches, finite)
    for q, got in pred_rec["rel_l2"].items():
        lo, hi = (g * pred_rec["r5_rel_l2"][q] for g in UQ_PREDICTIVE_GATE)
        assert lo <= got <= hi, (q, got, lo, hi)
        assert pred_rec["median_max_rel_gap"][q] <= UQ_MEDIAN_GAP_TOL, (q, pred_rec["median_max_rel_gap"])
    del system, res, pred

    # ---- (c) the device posterior on phase 15's trained system, card vs CPU; stretch and DRAM
    post_args = mcmc.parser.parse_args([str(trained), "--data", "spt100", "--qois", *UQ_QOIS])
    lps, fns = [], {}
    for where in ("cpu", "cuda"):
        sys_ = System.load_from_file(trained, device=where)
        calib = [v for v in sys_.inputs() if v.category == "calibration"]
        d_ops, d_obs, d_sig, d_fields = mcmc.build_dataset(sys_, post_args)
        fns[where] = mcmc.build_device_posterior(sys_, post_args, calib, [v.name for v in calib],
                                                 d_ops, d_obs, d_sig, d_fields)
        lps.append(fns[where][0](r5["draws"][:UQ_CHECK_THETAS]))
    lp_cpu, lp_card = lps
    assert np.all(np.abs(lp_cpu) < 1e29), lp_cpu  # every r5 draw lies in the domain
    post_err = float(np.max(np.abs(lp_card - lp_cpu) / np.abs(lp_cpu)))
    wrapper = fns["cuda"][0]
    wrapper(r5["draws"][:32])
    sync()
    t1 = time.perf_counter()
    for _ in range(50):
        wrapper(r5["draws"][:32])
    call_ms = (time.perf_counter() - t1) / 50 * 1e3
    theta32 = torch.as_tensor(r5["draws"][:32], dtype=torch.float32, device=dev)
    n_ops = count_dispatches(lambda: fns["cuda"][1](theta32))
    log(f"[16c posterior] {trained.name}, 17 parameters, QoIs {UQ_QOIS}: card vs CPU at {UQ_CHECK_THETAS} r5 "
        f"draws, max |diff| / |lp| {post_err:.3e} (tolerance {UQ_POSTERIOR_TOL:g}), lp in "
        f"[{lp_cpu.min():.4e}, {lp_cpu.max():.4e}]; {call_ms:.3f} ms a call at 32 walkers x 23 conditions, "
        f"{n_ops} aten operators dispatched a call ({call_ms * 1e3 / n_ops:.2f} us each)")
    assert post_err <= UQ_POSTERIOR_TOL and np.all(np.isfinite(lp_card)), (post_err, lp_card)
    rec["posterior"] = {"card_vs_cpu_rel_err": post_err, "tolerance": UQ_POSTERIOR_TOL,
                        "ms_per_call_32_walkers": call_ms, "aten_ops_per_call": n_ops}
    del fns, wrapper

    real_build = mcmc.build_device_posterior
    for sampler, walkers, iters in (("stretch", UQ_STRETCH_WALKERS, UQ_STRETCH_ITERS),
                                    ("dram", UQ_DRAM_WALKERS, UQ_DRAM_ITERS)):
        calls: list = []  # (batch rows, seconds) of every log-posterior call

        def counted(*a, **k):
            np_fn, torch_fn = real_build(*a, **k)

            def timed(theta):
                t = time.perf_counter()
                out = np_fn(theta)
                calls.append((np.shape(theta)[0], time.perf_counter() - t))
                return out

            return timed, torch_fn

        chain = build / f"{sampler}.npz"
        chain.unlink(missing_ok=True)
        mcmc.build_device_posterior = counted
        try:
            t1 = time.perf_counter()
            samples, logps, acc = mcmc.main([str(trained), "--data", "spt100", "--qois", *UQ_QOIS,
                                             "--sampler", sampler, "--walkers", str(walkers),
                                             "--niter", str(iters), "--file", str(chain), "--device", "cuda"])
            wall = time.perf_counter() - t1
        finally:
            mcmc.build_device_posterior = real_build
        sizes = collections.Counter(n for n, _ in calls)
        in_calls = sum(t for _, t in calls)
        evals = sum(n for n, _ in calls)
        back, back_lp = read_mcmc_chain(chain, burn_frac=0.0, clean=False)
        expect = {walkers // 2} if sampler == "stretch" else {walkers}
        log(f"[16c {sampler}] {walkers} walkers x {iters} iterations through mcmc.main on the card: "
            f"{wall:.3f} s in all, {len(calls)} log-posterior calls, batch sizes {dict(sizes)}, "
            f"{in_calls / len(calls) * 1e3:.3f} ms a call, {evals / in_calls:.0f} walker evaluations/s, "
            f"acceptance {acc:.3f}; chain {back.shape} read back from {chain.name}")
        assert calls and set(sizes) - {walkers} <= expect, sizes  # never the per-walker loop
        assert np.isfinite(samples).all() and np.isfinite(logps).all() and 0.0 < acc < 1.0, acc
        assert np.array_equal(back, samples) and np.array_equal(back_lp, logps)
        rec[sampler] = {"walkers": walkers, "iterations": iters, "wall_s": wall, "calls": len(calls),
                        "ms_per_call": in_calls / len(calls) * 1e3, "walker_evals_per_s": evals / in_calls,
                        "acceptance": acc}

    # ---- (d) Sobol' over the 18 calibration and nuisance inputs at one pressure
    card_sys = System.load_from_file(trained, device=dev)
    sweep = [v for v in card_sys.inputs() if v.category in ("calibration", "nuisance")]
    names = [v.name for v in sweep]
    sampler = sobol.column_sampler(sweep)
    qois = ["T", "I_d", "V_cc", "eta_a"]
    fn_calls: list = []
    card_fn = sobol.pressure_fn(card_sys, names, UQ_SOBOL_PB, qois)

    def timed_fn(x):
        sync()
        t = time.perf_counter()
        out = {k: v.cpu() for k, v in card_fn(x).items()}
        fn_calls.append((x, time.perf_counter() - t))
        return out

    t1 = time.perf_counter()
    big = sobol_sa(timed_fn, sampler, UQ_SOBOL_N, len(names), seed=16)
    wall = time.perf_counter() - t1
    (rows_x, cold_s), = fn_calls
    n_rows = len(rows_x)
    assert n_rows == UQ_SOBOL_N * (len(names) + 2), n_rows
    # sobol_sa's own call was the warm-up: the least of 3 more calls on its rows
    for _ in range(UQ_SOBOL_TIMED_CALLS):
        timed_fn(rows_x)
    fn_s = min(t for _, t in fn_calls[1:])
    small_card = sobol_sa(card_fn, sampler, UQ_SOBOL_CHECK_N, len(names), seed=17)
    cpu_sys = System.load_from_file(trained, device="cpu")
    small_cpu = sobol_sa(sobol.pressure_fn(cpu_sys, names, UQ_SOBOL_PB, qois), sampler, UQ_SOBOL_CHECK_N,
                         len(names), seed=17)
    sobol_err = max(float(np.max(np.abs(small_card[k] - small_cpu[k]))) for k in ("S1", "ST"))
    tops = {q: names[int(np.argmax(big["ST"][:, i]))] for i, q in enumerate(big["qois"])}
    log(f"[16d sobol] {len(names)} inputs, n = {UQ_SOBOL_N} at P_b = {UQ_SOBOL_PB:g}: {n_rows} rows in one "
        f"batch on the card in {fn_s * 1e3:.2f} ms, the least of {UQ_SOBOL_TIMED_CALLS} warm calls (the first, "
        f"cold, {cold_s * 1e3:.2f} ms) ({n_rows / fn_s:.0f} evaluations/s; sobol_sa {wall:.3f} s); "
        f"largest ST {tops}; card vs CPU at n = {UQ_SOBOL_CHECK_N}, max |diff| of S1 and ST {sobol_err:.3e} "
        f"(tolerance {UQ_SOBOL_TOL:g})")
    assert all(np.isfinite(big[k]).all() for k in ("S1", "ST")), big
    assert sobol_err <= UQ_SOBOL_TOL, sobol_err
    rec["sobol"] = {"inputs": len(names), "n": UQ_SOBOL_N, "rows": n_rows, "fn_ms": fn_s * 1e3,
                    "cold_fn_ms": cold_s * 1e3,
                    "evals_per_s": n_rows / fn_s, "sobol_sa_s": wall, "largest_ST": tops,
                    "card_vs_cpu_max_abs_err": sobol_err, "tolerance": UQ_SOBOL_TOL}
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[16 uq] done ({rec['wall_s']:.2f} s)")
    return rec


_PARALLEL_CHILD = r"""
import os, sys, time
import numpy as np
import torch

from hallthrusterpem_tpu_torch.parallel import distributed as dist, sharded_call
from hallthrusterpem_tpu_torch.pem import CoupledPEM

rank, out_dir = int(os.environ["HTPEM_RANK"]), os.environ["HTPEM_DIR"]
dist.initialize(coordinator_address=os.environ["HTPEM_ADDRESS"], num_processes=2, process_id=rank,
                local_device_ids=[0])
assert dist.is_distributed()
pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=float(os.environ["HTPEM_DURATION"]),
                 device="cuda")
with np.load(os.path.join(out_dir, "inputs.npz")) as f:
    full = {k: f[k] for k in f.files}
sl = dist.local_batch_slice(len(full["V_a"]))
mesh = dist.global_mesh()
walls = []
for _ in range(2):  # the first run is cold (the kernel library, PyTorch's own kernels)
    t0 = time.perf_counter()
    local = dist.process_local_batch({k: v[sl] for k, v in full.items()}, mesh)
    gathered = dist.gather_to_host(sharded_call(pem, mesh)(local))
    walls.append(time.perf_counter() - t0)
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **gathered)
torch.distributed.destroy_process_group()
print(f"RANK{rank}_OK {walls[0]:.6f} {walls[1]:.6f}", flush=True)
"""


def parallel_phase(pem, inputs: dict, ref: dict, n_launch: int, kstep_ms: float) -> dict:
    """Phase 17: the multi-device path on phase 4's ``inputs`` against its
    outputs ``ref``, bit for bit; ``n_launch`` is phase 4's launches a run.
    Returns the ``{"parallel": ...}`` record."""
    import os
    import socket
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from hallthrusterpem_tpu_torch.models.thruster import _kernels, simulate_batch_sharded
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.parallel import BatchExecutor, Mesh, make_mesh
    from hallthrusterpem_tpu_torch.pem import _coupled_post, _coupled_pre

    t0 = time.perf_counter()
    batch = len(inputs["V_a"])
    duration_ms = pem.cfg.duration * 1e3
    ref_np = {k: v.cpu().numpy() for k, v in ref.items()}

    def unequal(out) -> list:
        """The outputs that differ from phase 4's in any bit (NaN rows alike)."""
        got = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in out.items()}
        assert set(got) == set(ref_np), (sorted(got), sorted(ref_np))
        return [k for k in ref_np if got[k].dtype != ref_np[k].dtype
                or not np.array_equal(got[k], ref_np[k], equal_nan=True)]

    def sync_all(mesh):
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)

    rec: dict = {"batch": batch, "duration_s": pem.cfg.duration}

    # ---- (a) every card of the machine
    mesh = make_mesh()
    _kernels.reset_counts()
    t1 = time.perf_counter()
    out = BatchExecutor(mesh).run(pem, inputs)
    sync_all(mesh)
    wall = time.perf_counter() - t1
    launches = _kernels.launch_counts["kstep"]
    diff = unequal(out)
    log(f"[17a every card] BatchExecutor(make_mesh()) over {mesh.n_devices} card(s), B={batch}: {wall:.3f} s "
        f"({batch * duration_ms / wall:.2f} sim-ms/s), kstep launches {launches}; outputs that differ from "
        f"phase 4 in any bit: {diff or 'none'}")
    assert not diff, diff
    assert launches == mesh.n_devices * n_launch, (launches, mesh.n_devices, n_launch)
    rec["every_card"] = {"cards": mesh.n_devices, "wall_s": wall, "sim_ms_per_s": batch * duration_ms / wall,
                         "kstep_launches": launches, "bit_equal": True}

    # ---- (b) two shards on one card: simulate_batch_sharded, then the plume
    two = Mesh([torch.device("cuda", 0)] * 2)
    params, v_cc = _coupled_pre(inputs, pem.cfg)
    _kernels.reset_counts()
    t1 = time.perf_counter()
    sol = simulate_batch_sharded(params, pem.base_B, pem.cfg, two)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _kernels.launch_counts["kstep"]
    diff = unequal(_coupled_post(inputs, v_cc, sol, pem.sweep_radius, pem.cfg))
    log(f"[17b two shards] simulate_batch_sharded on Mesh([cuda:0, cuda:0]), 2 x {batch // 2} rows: {wall:.3f} s "
        f"({batch * duration_ms / wall:.2f} sim-ms/s), kstep launches {launches} (phase 4: {n_launch} a run); "
        f"outputs that differ from phase 4 in any bit: {diff or 'none'}")
    assert not diff, diff
    assert launches == 2 * n_launch, (launches, n_launch)
    rec["two_shards"] = {"wall_s": wall, "sim_ms_per_s": batch * duration_ms / wall, "kstep_launches": launches,
                         "bit_equal": True}

    # ---- (c) two processes on the card, gloo over localhost
    out_dir = Path("build") / "parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("rank*.npz"):
        old.unlink()
    np.savez(out_dir / "inputs.npz", **{k: v.cpu().numpy() for k, v in inputs.items()})
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t1 = time.perf_counter()
    procs = []
    for rank in range(2):
        env = dict(os.environ, HTPEM_RANK=str(rank), HTPEM_ADDRESS=f"127.0.0.1:{port}",
                   HTPEM_DIR=str(out_dir.resolve()), HTPEM_DURATION=repr(pem.cfg.duration))
        procs.append(subprocess.Popen([sys.executable, "-c", _PARALLEL_CHILD], env=env, cwd=Path(__file__).parent,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    child_walls = []
    try:
        for rank, proc in enumerate(procs):
            text = proc.communicate(timeout=PARALLEL_CHILD_TIMEOUT)[0]
            assert proc.returncode == 0 and f"RANK{rank}_OK" in text, f"rank {rank} failed:\n{text[-4000:]}"
            child_walls.append([float(w) for w in text.split(f"RANK{rank}_OK")[1].split()[:2]])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t1
    diffs = []
    for rank in range(2):
        with np.load(out_dir / f"rank{rank}.npz") as f:
            diffs.append(unequal({k: f[k] for k in f.files}))
    log(f"[17c two processes] 2 ranks on cuda:0 (gloo, port {port}), {batch // 2} rows each: both ranks "
        f"gathered {batch} rows; {wall:.3f} s with the processes' start; the sharded run and the gather "
        f"{max(w for w, _ in child_walls):.3f} s cold, {max(w for _, w in child_walls):.3f} s warm (the slower "
        f"rank); outputs that differ from phase 4 in any bit: rank 0 {diffs[0] or 'none'}, "
        f"rank 1 {diffs[1] or 'none'}")
    assert not diffs[0] and not diffs[1], diffs
    rec["two_processes"] = {"wall_s": wall, "run_and_gather_cold_s": max(w for w, _ in child_walls),
                            "run_and_gather_s": max(w for _, w in child_walls), "bit_equal": True}

    # ---- (d) the host's time per kstep launch, with 1 and 2 threads enqueuing
    K = fs.INNER_STEPS
    half = batch // 2
    carries = [fs.init_carry({k: v[i * half:(i + 1) * half].contiguous() for k, v in params.items()},
                             pem.base_B, pem.cfg) for i in range(2)]

    def enqueue(carry):
        consts, state, prof, sacc = carry
        for _ in range(PARALLEL_HOST_LAUNCHES):
            fs.kstep(state, prof, sacc, consts, 0, K, pem.cfg)

    pace = {}
    with ThreadPoolExecutor(max_workers=2) as pool:
        for n_threads in (1, 2, 1, 2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for future in [pool.submit(enqueue, c) for c in carries[:n_threads]]:
                future.result()
            host_s = time.perf_counter() - t1
            torch.cuda.synchronize()
            us = host_s / (n_threads * PARALLEL_HOST_LAUNCHES) * 1e6
            pace[n_threads] = min(pace.get(n_threads, math.inf), us)
    log(f"[17d host pace] host µs per kstep launch (B={half}, {PARALLEL_HOST_LAUNCHES} launches a thread, least "
        f"of 2 tries): 1 thread {pace[1]:.2f}, 2 threads {pace[2]:.2f} (aggregate); at {kstep_ms:.3f} ms a launch "
        f"one process could keep {kstep_ms * 1e3 / pace[2]:.0f} cards busy at the 2-thread pace "
        f"({kstep_ms * 1e3 / pace[1]:.0f} at the 1-thread pace)")
    rec["host_us_per_launch"] = {"1_thread": pace[1], "2_threads": pace[2]}
    rec["cards_one_process_could_feed"] = kstep_ms * 1e3 / pace[2]
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[17 parallel] done ({rec['wall_s']:.2f} s)")
    return rec


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits, NaN where NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(((a == b) | (a.isnan() & b.isnan())).all())


def workflow_phase(thruster_inputs: dict, tree_kw: dict) -> tuple:
    """Phase 18: the workflow scripts of ``hallthrusterpem_tpu_torch/scripts`` on
    the card. ``thruster_inputs`` and ``tree_kw`` are phase 9's inputs and
    wrapper arguments. Returns the ``{"workflow": ...}`` record and the entries
    of the ``kstep<1,1>`` and ``kstep<2,1>`` instantiations for the kernels line."""
    import numpy as np
    import torch

    from hallthrusterpem_tpu_torch.core.json_loader import config_dir, load_system
    from hallthrusterpem_tpu_torch.models.thruster import _kernels, hallthruster_jl
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.parallel import BatchExecutor, Mesh
    from hallthrusterpem_tpu_torch.pem import CoupledPEM, _coupled_pre, default_coupled_inputs
    from hallthrusterpem_tpu_torch.scripts import (debug, fit_surr, gen_data, install_solver, surr_report,
                                                   validate_solver)

    t_phase = time.perf_counter()
    dev, sync, K = torch.device("cuda", 0), torch.cuda.synchronize, fs.INNER_STEPS
    rec: dict = {}

    def parity(params, base_B, cfg) -> tuple:
        """One launch of the kernel and of its plain version from one carry:
        (max scaled error, max absolute error, arrays, the carry)."""
        cfg = dataclasses.replace(cfg, average_start_time=0.0)  # accumulate from step 0
        physics = fs.Physics(cfg)
        carry = fs.init_carry(params, base_B, cfg)
        outs = []
        for block in (fs.kstep, fs.kstep_plain):
            c = [x.clone() for x in carry[1:]]
            block(*c, carry[0], 0, K, cfg, physics)
            outs.append(c)
        sync()
        assert all(bool(torch.isfinite(x).all()) for x in outs[0]), "kernel carry not finite"
        return (*carry_errs(fs, outs[0], outs[1]), carry, cfg, physics)

    # ---- (a) install_solver: the build, a smoke run per fidelity; then kstep<1,1>
    # and kstep<2,1> against the plain version and timed at B = WORKFLOW_BATCH
    t0 = time.perf_counter()
    inst = install_solver.main([])
    sync()
    rec["install_solver"] = dict(inst, wall_s=time.perf_counter() - t0)
    for f in inst["fidelities"]:
        assert f["kstep_launches"] > 0 and f["finite"] > 0, f
    log(f"[18a install_solver] build " + ", ".join(f"{k} {v['seconds']:.2f} s (cached={v['cached']})"
                                                    for k, v in inst["build"].items())
        + "; " + "; ".join(f"fidelity {tuple(f['fidelity'])}: {f['wall_s']:.3f} s, {f['kstep_launches']} kstep "
                           f"launches, finite {f['finite']}" for f in inst["fidelities"]))
    launches = {tuple(f["fidelity"]): f["kstep_launches"] for f in inst["fidelities"]}
    entries = {}
    for fid in ((0, 0), (1, 1)):
        pem = CoupledPEM(thruster="SPT-100", model_fidelity=fid, duration=2e-5, device=dev)
        params, _ = _coupled_pre(default_coupled_inputs(WORKFLOW_BATCH, torch.Generator().manual_seed(18),
                                                        spread=0.08, device=dev), pem.cfg)
        err, err_abs, n_arrays, carry, cfg, physics = parity(params, pem.base_B, pem.cfg)
        name = f"kstep<{cfg.ncharge},{cfg.neutral_groups}>"
        launch = lambda block: block(carry[1], carry[2], carry[3], carry[0], 0, K, cfg, physics)
        ms = cuda_ms(lambda: launch(fs.kstep), 20, lead=True)
        plain_ms = cuda_ms(lambda: launch(fs.kstep_plain), 1)
        bound = kstep_bound(fs, _kernels, carry, cfg, physics)
        log(f"[18a {name}] fidelity {fid} ({cfg.num_cells} cells, {fs.lanes_for(cfg)} lanes), B={WORKFLOW_BATCH}: "
            f"1 launch (K={K}) vs {K} plain steps, max scaled error {err:.3e} (tolerance {STATE_RTOL:g}), max "
            f"absolute error {err_abs:.3e} over {n_arrays} arrays; {ms:.3f} ms/launch, plain {plain_ms:.1f} ms, "
            f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} ({ms / bound['bound_ms']:.2f}x)")
        assert err < STATE_RTOL, (name, err)
        entries[fid] = {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                        "launches": launches[fid], "launches_install_solver": launches[fid],
                        "max_abs_err": err_abs, "max_scaled_err": err, "scaled_err_tolerance": STATE_RTOL,
                        "batch": WORKFLOW_BATCH, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                        "bound_by": bound["bound_by"], "library_ms": None}
        del pem, params, carry

    # ---- (b) validate_solver at its own settings: kstep<1,1> at 100 cells, B = 10
    t0 = time.perf_counter()
    _kernels.reset_counts()
    res = validate_solver.main([])
    sync()
    n_val = _kernels.launch_counts["kstep"]
    cfg = res["cfg"]
    assert n_val == math.ceil(cfg.num_steps / K), (n_val, cfg.num_steps)
    finite = int(np.isfinite(res["out"]["thrust"]).sum())
    vcfg, vparams, vB = validate_solver.sweep_inputs()[:3]
    err, err_abs, n_arrays, carry, *_ = parity(vparams, vB, vcfg)
    rec["validate_solver"] = {"wall_s": time.perf_counter() - t0, "solve_s": res["wall_s"], "steps": cfg.num_steps,
                              "dt": cfg.dt, "kstep_launches": n_val, "rows": int(res["bad"].size),
                              "finite_rows": finite, "guarded_rows": int(res["bad"].sum()),
                              "physical_rows": res["physical_rows"], "trends_pass": True,
                              "kstep_max_scaled_err": err, "kstep_max_abs_err": err_abs}
    log(f"[18b validate_solver] {res['bad'].size} points, {cfg.num_cells} cells, {cfg.num_steps} steps at dt "
        f"{cfg.dt:.3e} s: solve {res['wall_s']:.3f} s, {n_val} kstep launches, finite {finite}, guarded "
        f"{int(res['bad'].sum())}, trends pass over {res['physical_rows']} physical points; one kstep<1,1> launch "
        f"at B=10 vs plain: max scaled error {err:.3e} (tolerance {STATE_RTOL:g}), max absolute {err_abs:.3e} "
        f"over {n_arrays} arrays")
    assert err < STATE_RTOL, err
    entries[(0, 0)]["launches"] += n_val
    entries[(0, 0)]["launches_validate_solver"] = n_val
    entries[(0, 0)]["max_scaled_err_validate_solver"] = err
    del carry, vparams

    # ---- (c) the pipeline on configs/pem_v0_SPT-100.json, the Thruster cut to
    # WRAPPER_DURATION: gen_data, then fit_surr --surrogate mlp at the r5 width
    work = Path("build") / "workflow"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    doc = json.loads((config_dir() / "pem_v0_SPT-100.json").read_text())
    thr = next(c for c in doc["components"] if c["name"] == "Thruster")
    thr["simulation"] = dict(thr["simulation"], duration=WRAPPER_DURATION)
    thr["postprocess"] = dict(thr["postprocess"], average_start_time=0.5 * WRAPPER_DURATION)
    (work / "pem_v0_SPT-100.json").write_text(json.dumps(doc))
    n_c, n_t = WORKFLOW_GEN
    _kernels.reset_counts()
    t0 = time.perf_counter()
    comp_path = gen_data.main([str(work / "pem_v0_SPT-100.json"), "-c", str(n_c), "-t", str(n_t)])
    sync()
    gen_s, gen_launches = time.perf_counter() - t0, _kernels.launch_counts["kstep"]
    sets = {}
    for tag in ("compression", "test_set"):
        with open(comp_path.parent / f"{tag}.pkl", "rb") as fd:
            d = pickle.load(fd)
        sets[tag] = {"rows": int(d["discard"].size), "kept": int((~d["discard"]).sum()),
                     "nan": int(d["nan_idx"].sum()), "outliers": int(d["outlier_idx"].sum())}
    system = load_system(comp_path, device=dev)
    ranks = {v.name: v.compression.rank for c in system.components for v in c.outputs if v.compression is not None}
    rec["gen_data"] = {"wall_s": gen_s, "rows_per_s": (n_c + n_t) / gen_s, "kstep_launches": gen_launches,
                       "sets": sets, "ranks": ranks}
    log(f"[18c gen_data] -c {n_c} -t {n_t}, Thruster {WRAPPER_DURATION:g} s: {gen_s:.3f} s "
        f"({(n_c + n_t) / gen_s:.1f} rows/s), {gen_launches} kstep launches; " + "; ".join(
            f"{t}: kept {v['kept']}/{v['rows']}, NaN {v['nan']}, outliers {v['outliers']}" for t, v in sets.items())
        + f"; ranks {ranks}")
    assert gen_launches > 0 and sets["compression"]["kept"] > n_c // 2 and sets["test_set"]["kept"] > n_t // 2
    assert set(ranks) == {"u_ion", "j_ion"} and all(r >= 1 for r in ranks.values()), ranks

    m = WORKFLOW_MLP
    assert not torch.backends.cuda.matmul.allow_tf32
    _kernels.reset_counts()
    t0 = time.perf_counter()
    trained_path = fit_surr.main([str(comp_path), "--surrogate", "mlp", "--mlp-samples", str(m["samples"]),
                                  "--mlp-steps", str(m["steps"]), "--mlp-hidden", *map(str, m["hidden"]),
                                  "--mlp-ensemble", str(m["ensemble"])])
    sync()
    fit_s, fit_launches = time.perf_counter() - t0, _kernels.launch_counts["kstep"]
    assert not torch.backends.cuda.matmul.allow_tf32
    trained = load_system(trained_path, device=dev)
    errors = trained.system_surrogate.test_errors(*fit_surr.load_test_set(comp_path))
    rec["fit_surr"] = {"wall_s": fit_s, "kstep_launches": fit_launches, **m, "test_rel_l2": errors,
                       "n_train": trained.system_surrogate.train_info["n_train"]}
    log(f"[18c fit_surr] --surrogate mlp, {m['samples']} samples labelled ({fit_launches} kstep launches), "
        f"{m['steps']} steps at {m['hidden']} x {m['ensemble']}: {fit_s:.3f} s; test rel-L2 "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(errors.items())))
    assert fit_launches > 0 and errors and all(math.isfinite(v) for v in errors.values()), errors
    del system, trained

    # ---- (d) surr_report on the r5 trained state and test set
    t0 = time.perf_counter()
    r5 = Path("runs") / "r5" / "surr"
    rep = surr_report.main([str(r5), "-o", str((work / "r5_report.json").resolve()),
                            "--config", "pem_v0_SPT-100_compression.json"])
    ref = json.loads((r5 / "report.json").read_text())
    gaps = {k: abs(rep["rel_l2"][k] - v) for k, v in ref["rel_l2"].items()}
    gaps["I_d.global_rel_l2"] = abs(rep["I_d"]["global_rel_l2"] - ref["I_d"]["global_rel_l2"])
    rec["surr_report"] = {"wall_s": time.perf_counter() - t0, "n_test": rep["n_test"], "rel_l2": rep["rel_l2"],
                          "I_d": rep["I_d"], "eta_c": rep["eta_c"], "largest_gap_to_r5": max(gaps.values())}
    log(f"[18d surr_report] r5 ensemble on r5's {rep['n_test']} test rows, on the card: rel-L2 "
        + ", ".join(f"{k} {v:.4f}" for k, v in rep["rel_l2"].items())
        + f"; largest gap to runs/r5/surr/report.json {max(gaps.values()):.1e} (tolerance {WORKFLOW_REPORT_TOL:g})")
    assert rep["n_test"] == ref["n_test"] and set(rep["rel_l2"]) == set(ref["rel_l2"])
    assert max(gaps.values()) <= WORKFLOW_REPORT_TOL, gaps

    # ---- (e) debug over make_mesh()
    rec["debug"] = debug.main([])
    log(f"[18e debug] {rec['debug']}")

    # ---- (f) the wrapper sharded by BatchExecutor over Mesh([cuda:0, cuda:0]),
    # bit for bit against the unsharded call
    t0 = time.perf_counter()
    dur = WORKFLOW_SHARDED_DURATION
    kw = dict(tree_kw, simulation=dict(tree_kw["simulation"], duration=dur),
              postprocess=dict(tree_kw["postprocess"], average_start_time=0.5 * dur), device=dev)
    _kernels.reset_counts()
    ref = hallthruster_jl(thruster_inputs, **kw)
    n_ref = _kernels.launch_counts["kstep"]
    _kernels.reset_counts()
    got = BatchExecutor(Mesh([dev, dev])).run(hallthruster_jl, thruster_inputs, **kw)
    sync()
    n_got = _kernels.launch_counts["kstep"]
    keys = [k for k, v in ref.items() if isinstance(v, torch.Tensor) and k != "model_cost"]
    raw_ref, raw_got = (o["thruster_output"]["output"]["average"] for o in (ref, got))
    raw_keys = [k for k, v in raw_ref.items() if isinstance(v, torch.Tensor)]
    unequal = [k for k in keys if not same_bits(got[k], ref[k])]
    unequal += [f"raw {k}" for k in raw_keys if not same_bits(raw_got[k], raw_ref[k])]
    unequal += [f"raw ui[{z}]" for z, (a, b) in enumerate(zip(raw_got["ui"], raw_ref["ui"])) if not same_bits(a, b)]
    batch = len(thruster_inputs["V_a"])
    finite = int(torch.isfinite(ref["T"]).sum())
    rec["sharded_wrapper"] = {"batch": batch, "duration": dur, "kstep_launches_unsharded": n_ref,
                              "kstep_launches_two_shards": n_got, "finite_rows": finite, "bit_equal": not unequal,
                              "wall_s": time.perf_counter() - t0}
    log(f"[18f sharded wrapper] BatchExecutor(Mesh([cuda:0, cuda:0])).run(hallthruster_jl), B={batch}, {dur:g} s: "
        f"kstep launches {n_got} (unsharded {n_ref}), finite rows {finite}; outputs and raw averages that differ "
        f"from the unsharded call in any bit: {unequal or 'none'} ({time.perf_counter() - t0:.2f} s)")
    assert not unequal and n_got == 2 * n_ref, (unequal, n_got, n_ref)

    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[18 workflow] done ({rec['wall_s']:.2f} s)")
    return rec, [entries[(0, 0)], entries[(1, 1)]]


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
    from hallthrusterpem_tpu_torch.core.json_loader import load_system
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
    max_err, max_abs, n_arrays = carry_errs(fs, (ks, kp, ka), (ps, pp, pa))
    log(f"[3 parity] 1 launch (K={K}) vs {K} plain steps, B={batch}: max scaled error {max_err:.3e} "
        f"(tolerance {STATE_RTOL:g}), max absolute error {max_abs:.3e} over {n_arrays} arrays")
    assert max_err < STATE_RTOL, max_err
    ks, kp, ka = run(fs.kstep, 20)
    ps, pp, pa = run(fs.kstep_plain, 20)
    acc_err = max(float(((ka[:, j] - pa[:, j]).abs() / pa[:, j].abs().clamp_min(1e-30)).max())
                  for j in (fs.A_THRUST, fs.A_ID, fs.A_ID2, fs.A_IB0, fs.A_MDOT, fs.A_UEXIT))
    assert torch.equal(ka[:, fs.A_FAILED], pa[:, fs.A_FAILED])
    log(f"[3 parity] 20 launches vs {20 * K} plain steps: accumulators max relative error "
        f"{acc_err:.3e} (tolerance {QOI_RTOL:g}) ({time.perf_counter() - t0:.2f} s)")
    assert acc_err < QOI_RTOL
    # free phase 3's B = 1024 copies so phase 4's peak memory is the main path's own
    del params, consts, state0, prof0, sacc0, ks, kp, ka, ps, pp, pa

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
    main_inputs, main_out = inp, out  # phase 17 holds the multi-device path to these, bit for bit
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
    bound = kstep_bound(fs, _kernels, (consts, state, prof, sacc), pem.cfg, physics)
    bound_ms = bound["bound_ms"]
    lanes = batch * fs.lanes_for(pem.cfg)
    log(f"[6 timing] kstep B={batch} K={K}: {ms:.3f} ms/launch ({ms / K * 1e3:.2f} us/step, "
        f"{ms / bound_ms:.2f}x the bound), plain {plain_ms:.1f} ms; {bound['ops_per_step'] / lanes:.0f} ops per "
        f"lane-step, {bound['ops']:.3e} ops and {bound['bytes']:.3e} bytes per launch -> bound {bound_ms:.4f} ms "
        f"(ops {bound['ops_ms']:.4f}, bytes {bound['bytes_ms']:.4f}); {barriers} block barriers per step, "
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
    kstep_bound_3 = (bound_ms, bound["bound_by"])
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
    thruster_comp = load_system("pem_v0_SPT-100.json", device=dev)["Thruster"]
    comp, fidelity = thruster_comp.model_kwargs, thruster_comp.model_fidelity
    simulation = dict(comp["simulation"], duration=WRAPPER_DURATION)
    postprocess = dict(comp["postprocess"], average_start_time=0.5 * WRAPPER_DURATION)
    tree_kw = dict(thruster=comp["thruster"], config=comp["config"], simulation=simulation,
                   postprocess=postprocess, model_fidelity=fidelity)
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
    log(f"[9 wrapper path] hallthruster_jl, fidelity {fidelity}, {wcfg.num_cells} cells, "
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

    # ---- 12-13. the lax solver; 14. the System path
    lax = lax_phases(kstep_ms / K * 1e3)
    lax["system"] = system_phase()
    # ---- 15. the surrogates
    surrogate = surrogate_phase()
    # ---- 16. the UQ path (on phase 15's saved system)
    uq = uq_phase(Path("build") / "surrogate" / "surrogate_trained.json")
    # ---- 17. the multi-device path (on phase 4's inputs and outputs)
    parallel = parallel_phase(pem, main_inputs, main_out, n_launch, kstep_ms)
    # ---- 18. the workflow scripts (on phase 9's inputs for the sharded wrapper)
    workflow, low_fidelity_kernels = workflow_phase(thruster_inputs(42), tree_kw)

    kernels = [{
        "name": "kstep", "instantiation": kname, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches["kstep"], "launches_wrapper_path": wrapper_launches["kstep"],
        "launches_uq_predictive": uq["predictive"]["kstep_launches"],
        "launches_two_shards": parallel["two_shards"]["kstep_launches"],
        "launches_gen_data": workflow["gen_data"]["kstep_launches"],
        "launches_fit_surr": workflow["fit_surr"]["kstep_launches"],
        "max_abs_err": max_abs, "max_scaled_err": max_err,
        "max_scaled_err_trace": variant_err["trace"], "max_scaled_err_two_group": variant_err["two_group"],
        "scaled_err_tolerance": STATE_RTOL, "ms": kstep_ms, "plain_ms": kstep_plain_ms,
        "bound_ms": kstep_bound_3[0], "bound_by": kstep_bound_3[1], "library_ms": None,
        "blocks_per_sm": blocks_per_sm, "barriers_per_step": barriers, "sass_instructions": len(sass),
        "sass_instructions_per_step": step_insns, "sm_clock_mhz": sm_mhz, "issue_us_per_step": issue_us,
    }, *low_fidelity_kernels, {
        "name": "step", "route": "cuda", "source": STEP_SOURCE, "replaces": STEP_REPLACES,
        "launches": step_launches["step"], "max_abs_err": step_abs, "max_scaled_err": step_err,
        "scaled_err_tolerance": STATE_RTOL, "ms": step_ms, "host_paced_ms": step_paced_ms,
        "plain_ms": step_plain_ms,
        "bound_ms": max(s_ops_ms, s_bytes_ms),
        "bound_by": "operations" if s_ops_ms >= s_bytes_ms else "bytes",
        "library_ms": None,
    }]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"lax": lax}), flush=True)
    print(json.dumps({"surrogate": surrogate}), flush=True)
    print(json.dumps({"uq": uq}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"workflow": workflow}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
