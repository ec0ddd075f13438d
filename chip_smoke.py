#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--duration SECONDS]

Phases, each printed with its seconds:

1. device: the card's name, and its name and power limit from ``nvidia-smi``;
2. build: the K-step kernel (``csrc/kstep.cu``), the one-step kernel
   (``csrc/step.cu``) and the plume's kernel (``models/csrc/plume.cu``), one
   nvcc each, started together, and ptxas's
   register / shared-memory / spill lines; the K-step kernel's blocks per SM
   at the main path's config, and from its SASS (``cuobjdump``) the block
   barriers and instructions of one step and the instruction count by opcode;
3. kernel against its plain PyTorch version on the card at the main path's
   shapes (fidelity (2,2): 202 cells, 224 lanes, 3 charge states, plume on;
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
10. the one-step driver at B = 1024, 914 steps, through its CUDA graphs and
    through its eager route (equal bit for bit, each launching the step kernel
    914 times; timed, the captures apart), against the K-step driver;
11. the one-step kernel's time per launch, its plain version's and its bound;
12. the lax solver (fidelity (2,2), B = 8, 200 steps) on the card against the
    same code on the host CPU: in float64, the config's own precision, which
    routes it to the lax solver, and in float32 through ``solver`` directly; on
    the card its replayed CUDA graphs against its eager route, bit for bit;
13. the full-width lax path: ``CoupledPEM(model_fidelity=(4,2))`` (300 cells + 2
    ghosts, 3 charge states) at B = 1024 for 2,000 steps through the CUDA
    graphs in one segment and in 500-step chunks, and through the eager route,
    all three equal bit for bit, timed; then float64 at fidelity (2,2),
    B = 1024, 500 steps, timed; the capture's seconds and ``LAX_REPLAYS``
    replays of one graph timed, and the card's busy time a step from
    ``torch.profiler`` traces of one replay and of 20 eager steps;
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
    I_d, u_ion, j_ion): its CUDA graphs (one per walker count) against its
    eager route bit for bit at ``UQ_GRAPH_WALKERS`` walkers, on the card
    against the CPU, each value within ``UQ_POSTERIOR_TOL`` of its own, both
    routes timed; then ``mcmc.main`` with the stretch sampler
    (``UQ_STRETCH_WALKERS`` x ``UQ_STRETCH_ITERS``) and with DRAM
    (``UQ_DRAM_WALKERS`` x ``UQ_DRAM_ITERS``) through each route, every
    log-posterior call on the whole batch, the ``.npz`` chain read back equal
    and the two routes' chains equal; (d) ``sobol_sa`` over the 18 calibration and
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
    bit for bit against the unsharded call;
19. the SPT-100 physics studies of ``hallthrusterpem_tpu_torch/scripts`` on the
    card, uncut: (a) ``anchors`` (10 conditions, B = 10, 2e-3 s) held to the
    TPU run's ``runs/r5/anchors.json`` (median scalar deviation within
    ``STUDY_MEDIAN_TOL``, each within ``STUDY_EACH_TOL``, each profile rel-L2
    within ``STUDY_PROFILE_GATE`` x r5's), with the anchor table's own verdict
    printed beside the gate; (b) ``tune_r5 -n 256`` (768 rows at 2e-3 s in one
    batch), at least ``STUDY_TUNE_FINITE`` of its rows finite and its table
    within ``STUDY_MEDIAN_TOL`` (median) of ``runs/r5/tune_b_w093.json`` on the
    candidates both score; (c) ``probe_uion``, ``diagnose_current``,
    ``probe_anom_shape``, ``probe_anode_zone``, each with finite rows; (d)
    ``diagnose_breathing`` at its defaults through the K-step route, then a
    short lax-route run; (e) ``kernel_bench`` at ``STUDY_BENCH`` (CUDA events
    around each run), its µs a step within ``STUDY_BENCH_TOL`` of the same run
    timed launch by launch, and the first 20 launches (every row still healthy,
    as in phase 6) within ``STUDY_BENCH_TOL`` of phase 6's; most of the
    configuration's rows fail within ~1,200 steps (dt 5e-9 s at 200 cells), and
    a step of the kernel then costs more, so the whole run is not held to phase 6;
20. (a) ``parity_tpu`` (the K-step kernel, ``kstep<3,1>`` and ``kstep<3,2>``,
    against the lax solver's CUDA graphs, B = 32): every config over ~1,100
    steps, T, I_d, I_B0 within ``QOI_RTOL``; ``run_config`` on ``PARITY_FIRST``
    at a horizon cut to ``PARITY_DURATION`` (uncut 2e-3 s), the script's own
    verdicts recorded beside those of the kernel against itself with V_a one
    ulp apart (which misses them too at a cut horizon); (b)
    ``gen_mlp_data`` labels ``SWEEP_ROWS`` rows through ``kstep`` into
    ``build/sweep/``, ``mlp_sweep`` fits ``SWEEP_VARIANTS`` (their steps cut to
    ``SWEEP_STEPS``) scored on r5's test set, and the saved best reloads bit for
    bit;
21. ``python -m hallthrusterpem_tpu_torch.bench`` (the port of ``bench.py``)
    with its defaults as a child process: its JSON line with ``bench.py``'s
    keys and a finite value, at least ``BENCH_FINITE`` of 1024 rows finite,
    ``ceil(steps / 50)`` kstep launches in each timed run, and its value within
    ``BENCH_GATE`` of ``1024 * 0.5 sim-ms / (launches x phase 6's ms a launch)``;
22. the plume's kernel against its plain version at the rows a call of each
    benchmark cell holds (``PLUME_ROWS``), with the thrust ``T`` and every
    eighth row masked (NaN ``I_B0`` and ``T``), in float32, in float64 and mixed
    as the Thruster gives them once a row is masked (``I_B0`` and ``T`` in
    float64, the rest float32): every output, ``T_c`` among them, of the plain
    version's type and within ``PLUME_TOL`` (scaled; the divergence angle in
    float32 within ``PLUME_DIV_TOL_F32``), one launch a call; its time on the
    card a launch (back to back), its host time a call, its bound, and the plain
    version's wall a call and operators a call;
23. the pem_v0 H9-class system (GaussianBohm transport under a
    SimpleLogisticShift pressure response; no ion wall losses, plume expansion
    or circuit): ``System.predict(use_model="best")`` on the benchmark's frozen
    ``H9_CONFIG`` (fidelity (2,2), 5e-5 s) at one call of its facility sweep
    (``H9_MIX``, 1,024 rows at four chamber pressures): ``kstep<3,1>`` with
    those flags, ``ceil(steps / K)`` launches, its first launch against the
    plain version from the same carry (within ``STATE_RTOL``), the finite share
    of the rows at each pressure, and the counters ``gaussian_bohm_rows`` and
    ``plume_kernel_rows`` equal to ``rows_attempted``; a second call timed;
24. the K-step kernel's lane width: ``kstep<3,1>`` at fidelity (2,2) on its
    224 lanes against the same launches forced onto 256, bit for bit on lanes
    0..NC-1 and the accumulators, timed at each batch of ``WIDTH_BATCHES``;
    registers, spill bytes, barriers and static instructions a warp-step of
    each instance (and of ``kstep<1,1>`` at 128 lanes); and a probe of where
    the warps of four co-resident 224-thread blocks sit on an SM's schedulers.

It prints a ``{"lax": {...}}`` line (phases 12-14), a ``{"surrogate": {...}}``
line (phase 15), a ``{"uq": {...}}`` line (phase 16), a ``{"parallel": {...}}``
line (phase 17), a ``{"workflow": {...}}`` line (phase 18), a ``{"studies": {...}}``
line (phase 19), a ``{"parity_sweep": {...}}`` line (phase 20), a ``{"bench": {...}}``
line (phase 21), a ``{"h9": {...}}`` line (phase 23), a ``{"widths": {...}}`` line (phase 24), a ``{"kernels": [...]}``
line (``kstep<3,1>``, ``kstep<1,1>``, ``kstep<2,1>``, ``step``, ``plume``), the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; without
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
LEAD_CYCLES = 200_000_000  # ~0.1 s: the card's spin before back-to-back timed launches
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
LAX_REPLAYS = 4  # phase 13: replays of one captured graph, timed
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
UQ_GRAPH_WALKERS = (8, 32, 64)  # walker counts whose graphs are held to the eager route
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
# phase 19: the anchors gate against the TPU run's artifact, with the repo's
# parity tolerances (scripts/parity_tpu.py: 2% on the median, the 30% attractor
# cut on each QoI) and phase 16's band on each profile rel-L2; tune_r5's
# candidates, the floor on the finite share of its rows and the r5 sweep that
# the script's defaults reproduce (its candidates below 256 are those of
# -n 256); diagnose_breathing's short lax-route run; kernel_bench's batch and
# steps, and the bound on its time a step against the same run timed launch by
# launch, and on its first launches (healthy rows, as phase 6's) against phase 6
STUDY_R5_ANCHORS = Path("runs") / "r5" / "anchors.json"
STUDY_R5_TUNE = Path("runs") / "r5" / "tune_b_w093.json"
STUDY_MEDIAN_TOL = 0.02
STUDY_EACH_TOL = 0.30
STUDY_PROFILE_GATE = (0.75, 1.25)
STUDY_TUNE_N = 256
STUDY_TUNE_FINITE = 0.95
STUDY_LAX_BREATHING = ["--every", "7", "--duration", "1.5e-6"]
STUDY_BENCH = (1024, 20000)
STUDY_BENCH_TOL = 0.05
# phase 20: parity_tpu at B = 32: every config over ~1,100 steps; run_config
# at a horizon cut to the guards' floor (uncut 2e-3 s: ~913,661 steps, ~22 min
# of lax a config) on the nominal and the two-group configs, beside the kernel
# against itself with V_a one ulp apart; the MLP sweep's labelled rows (r5:
# ~49k), variants and steps
PARITY_BATCH = 32
PARITY_SHORT = 2.5e-6
PARITY_DURATION = 2e-4
PARITY_FIRST = ("nominal_300V_5.16mg", "two_group_nominal")
PARITY_ULP = 2.0**-22
SWEEP_ROWS = 1024
SWEEP_VARIANTS = ("base6k", "wide512")
SWEEP_STEPS = 300
# phase 21: the bench's child process, its finite rows and its value against
# batch * 0.5 sim-ms / (launches x phase 6's ms a launch)
BENCH_TIMEOUT = 300
BENCH_FINITE = 1014
BENCH_GATE = (0.90, 1.10)
# phase 22: the plume's kernel
PLUME_SOURCE = "hallthrusterpem_tpu_torch/models/csrc/plume.cu"
PLUME_ROWS = (23, 1024, 1472)  # a call of a22_mcmc_eval, a00_labelling, a22_predictive
PLUME_TOL = 1e-6
PLUME_DIV_TOL_F32 = 5e-6  # the sum order alone moves arccos by up to 2.1e-6 (tests/test_torch_plume_emulated.py)
PLUME_REPS = 200
# phase 23: the H9-class system at one call of the benchmark's h9_facility_sweep cell
H9_CONFIG = "pembench/configs/h9_pem_v0_a22.json"
H9_MIX = "h9_pressure_sweep"
H9_SEED = 23
# phase 24: the K-step kernel's lane width
WIDTH_BATCHES = {1024: 20, 23: 50, 1: 50}  # batch -> timed launches (a22_predictive's, a22_mcmc_eval's, one row)
WIDTH_ORDER = (224, 256, 256, 224)  # each width timed twice, in this order, from the same carry
PROBE_SPIN_CYCLES = 2_000_000  # ~1 ms: every probe block of the one wave resident at once
# the probe of phase 24: each warp of one wave of 224-thread blocks, four to an
# SM (held there by 56 KB of shared memory a block), records its SM, its
# hardware slot (%warpid) and its block, then spins so that the SM's blocks
# overlap; a slot's scheduler is taken as the slot mod 4
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(224, 4) probe_kernel(int* out, long long spin) {
  extern __shared__ float pad[];
  unsigned sm, slot;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
  const long long t0 = clock64();
  while (clock64() - t0 < spin) pad[threadIdx.x] = (float)t0;
  if ((threadIdx.x & 31) == 0) {
    int* o = out + 3 * (blockIdx.x * 7 + threadIdx.x / 32);
    o[0] = (int)sm;
    o[1] = (int)slot;
    o[2] = blockIdx.x;
  }
}
extern "C" int probe_run(int* host, int blocks, long long spin) {
  const int smem = 56 * 1024;
  int* dev = nullptr;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaMalloc(&dev, sizeof(int) * 3 * 7 * blocks);
  if (err == cudaSuccess) {
    probe_kernel<<<blocks, 224, smem>>>(dev, spin);
    err = cudaDeviceSynchronize();
  }
  if (err == cudaSuccess) err = cudaMemcpy(host, dev, sizeof(int) * 3 * 7 * blocks, cudaMemcpyDeviceToHost);
  cudaFree(dev);
  return (int)err;
}
"""


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


def ptxas_usage(log_text: str, mangled: str) -> dict:
    """Registers and spill bytes that ptxas gave the kernel whose mangled name
    starts with ``mangled``, from a build's ``-Xptxas -v`` log."""
    for block in re.split(r"Compiling entry function '", log_text)[1:]:
        if block.startswith(mangled):
            regs = re.search(r"Used (\d+) registers", block)
            stores = re.search(r"(\d+) bytes spill stores", block)
            loads = re.search(r"(\d+) bytes spill loads", block)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(stores.group(1)) if stores else None,
                    "spill_loads": int(loads.group(1)) if loads else None}
    raise RuntimeError(f"no ptxas lines for {mangled}")


def kstep_mangled(ncharge: int, groups: int, lanes: int) -> str:
    """The start of the mangled name of the K-step instance that a launch of
    ``lanes`` threads runs: bounded at 256 threads for 128 and 256 lanes and
    for two neutral groups, else at 224 (``KSTEP_TABLE`` in csrc/kstep.cu)."""
    bound = 256 if lanes in (128, 256) or groups == 2 else 224
    return f"_Z12kstep_kernelILi{ncharge}ELi{groups}ELi{bound}E"


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
    With ``lead`` the card first spins for ~0.1 s (``LEAD_CYCLES``) so that the
    host enqueues every timed call before the first one starts: the events then
    bracket back-to-back kernels, not the host's launch pace, which a kernel of a
    few µs launched through Python checks and ctypes would measure."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if lead:
        torch.cuda._sleep(LEAD_CYCLES)
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


def same_carry(solver, a, b) -> bool:
    """Two lax carries equal bit for bit (NaN where NaN)."""
    return all(same_bits(x, y) for x, y in zip(solver._leaves(a), solver._leaves(b)))


def lax_card_vs_cpu(cfg, params, base_B, n_steps: int) -> tuple:
    """Phase 12 for one config: ``n_steps`` lax-solver steps on the card
    (replayed CUDA graphs, then the eager route from the same carry) and on the
    host CPU from the same inputs. Returns the largest scaled error of the
    card's graphed carry against the host's over the state and the running sums
    (the failure flags must agree), whether the graphed carry equals the eager
    one bit for bit, and both routes' seconds (the graphs' with their capture)."""
    import torch

    from hallthrusterpem_tpu_torch.models.thruster import solver

    carry = solver._init_batch(params, base_B, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = solver._segment_batch(params, base_B, carry, cfg, n_steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eager = solver._segment_batch_eager(params, base_B, carry, cfg, n_steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cpu_p, cpu_b = {k: v.cpu() for k, v in params.items()}, base_B.cpu()
    cpu = solver._segment_batch(cpu_p, cpu_b, solver._init_batch(cpu_p, cpu_b, cfg), cfg, n_steps)
    (card_state, card_acc, card_i, card_failed), (cpu_state, cpu_acc, _, cpu_failed) = card, cpu
    assert int(card_i) == n_steps, int(card_i)
    assert torch.equal(card_failed.cpu(), cpu_failed), "failure flags differ"
    pairs = list(zip(card_state, cpu_state)) + [(card_acc[k], cpu_acc[k]) for k in cpu_acc]
    for got, _ in pairs:
        assert got.device.type == params["V_d"].device.type and got.dtype == solver._dtype(cfg)
    return (max(scaled_err(got.cpu(), ref) for got, ref in pairs), same_carry(solver, card, eager),
            t1 - t0, t2 - t1)


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
    # ---- 12. lax on the card against lax on the host CPU: fidelity (2,2), B = 8;
    # on the card, the replayed graphs against the eager route bit for bit
    t0 = time.perf_counter()
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=2e-5, device=dev)
    inp = default_coupled_inputs(LAX_PARITY_BATCH, torch.Generator().manual_seed(12), spread=0.08, device=dev)
    for dtype in ("float32", "float64"):
        cfg = dataclasses.replace(pem.cfg, dtype=dtype, average_start_time=0.0,
                                  duration=LAX_PARITY_STEPS * pem.cfg.dt)
        assert thruster.uses_lax_solver(cfg) == (dtype == "float64")
        params, _ = _coupled_pre(inp, cfg)
        err, equal, graph_s, eager_s = lax_card_vs_cpu(cfg, params, pem.base_B, LAX_PARITY_STEPS)
        record[f"card_vs_cpu_scaled_err_{dtype}"] = err
        record[f"graph_equals_eager_{dtype}"] = equal
        record[f"parity_graph_s_{dtype}"], record[f"parity_eager_s_{dtype}"] = graph_s, eager_s
        log(f"[12 lax parity] {dtype}, {cfg.num_cells} cells, {cfg.ncharge} charge states, "
            f"B={LAX_PARITY_BATCH}, {LAX_PARITY_STEPS} steps: card vs host CPU max scaled error {err:.3e} "
            f"(tolerance {LAX_TOL[dtype]:g}); on the card the CUDA graphs ({graph_s:.3f} s with their capture) "
            f"{'equal' if equal else 'DIFFER FROM'} the eager route ({eager_s:.3f} s) bit for bit")
        assert err < LAX_TOL[dtype], (dtype, err)
        assert equal, f"{dtype}: graphed lax steps differ from the eager ones"
    log(f"[12 lax parity] done ({time.perf_counter() - t0:.2f} s)")

    # ---- 13. the full-width lax path: CoupledPEM at fidelity (4,2), B = 1024,
    # replayed graphs (monolithic, chunked) and the eager route, all equal bit for bit
    t0 = time.perf_counter()
    probe = CoupledPEM(thruster="SPT-100", model_fidelity=(4, 2), duration=1e-6, device=dev)
    wide = CoupledPEM(thruster="SPT-100", model_fidelity=(4, 2), duration=LAX_WIDE_STEPS * probe.cfg.dt,
                      device=dev)
    assert thruster.uses_lax_solver(wide.cfg) and wide.cfg.nc == 302 and wide.cfg.num_steps == LAX_WIDE_STEPS
    inp = default_coupled_inputs(batch, torch.Generator().manual_seed(13), spread=0.08, device=dev)
    _kernels.reset_counts()
    runs = {}
    graphed = solver._segment_batch
    for label, chunk_steps, segment in (("monolithic", None, graphed), ("chunked", LAX_CHUNK, graphed),
                                        ("eager", None, solver._segment_batch_eager)):
        solver._segment_batch = segment
        try:
            t1 = time.perf_counter()
            runs[label] = wide(inp, chunk_steps=chunk_steps)
            sync()
            runs[label + "_s"] = time.perf_counter() - t1
        finally:
            solver._segment_batch = graphed
    assert _kernels.launch_counts == {"kstep": 0, "step": 0}, _kernels.launch_counts
    mono = runs["monolithic"]
    for label in ("chunked", "eager"):
        diff = [k for k in mono if not same_bits(mono[k], runs[label][k])]
        assert not diff, f"the {label} run differs from the monolithic graphed one in {diff}"
    n_ok = int(torch.isfinite(mono["T"]).sum())
    steps = wide.cfg.num_steps
    wide_rec = {"num_cells": wide.cfg.num_cells, "ncharge": wide.cfg.ncharge, "batch": batch,
                "duration_s": wide.cfg.duration, "steps": steps, "graph_steps": solver.GRAPH_STEPS,
                "wall_s": runs["monolithic_s"], "wall_chunked_s": runs["chunked_s"], "chunk_steps": LAX_CHUNK,
                "wall_eager_s": runs["eager_s"], "ms_per_step": runs["monolithic_s"] / steps * 1e3,
                "eager_ms_per_step": runs["eager_s"] / steps * 1e3,
                "sim_ms_per_s": batch * wide.cfg.duration * 1e3 / runs["monolithic_s"],
                "eager_sim_ms_per_s": batch * wide.cfg.duration * 1e3 / runs["eager_s"], "finite": n_ok}
    record["fidelity_4_2_float32"] = wide_rec
    log(f"[13 lax wide] CoupledPEM fidelity (4,2): {wide.cfg.num_cells} cells + 2 ghosts, {wide.cfg.ncharge} "
        f"charge states, B={batch}, duration {wide.cfg.duration:.4e} s = {steps} steps: CUDA graphs of "
        f"{solver.GRAPH_STEPS} steps {runs['monolithic_s']:.3f} s monolithic ({wide_rec['ms_per_step']:.3f} "
        f"ms/step, {wide_rec['sim_ms_per_s']:.3f} sim-ms/s, capture included), {runs['chunked_s']:.3f} s in "
        f"{LAX_CHUNK}-step chunks; eager {runs['eager_s']:.3f} s ({wide_rec['eager_ms_per_step']:.3f} ms/step); "
        f"all three equal bit for bit; finite {n_ok}/{batch} (kstep at fidelity (2,2): {kstep_us:.2f} us/step)")
    assert n_ok >= batch - 10, n_ok
    del runs, mono
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
    log(f"[13 lax float64] CoupledPEM fidelity (2,2) in float64, B={batch}, {pem64.cfg.num_steps} steps, CUDA "
        f"graphs: wall {wall:.3f} s with the capture, {f64_rec['ms_per_step']:.3f} ms/step, "
        f"{f64_rec['sim_ms_per_s']:.3f} sim-ms/s, finite {n_ok}/{batch}, outputs float64")
    assert n_ok >= batch - 10, n_ok
    # the capture's seconds and a graph's steady pace on the fidelity (4,2)
    # inputs: one graph of GRAPH_STEPS steps captured, replayed LAX_REPLAYS times
    params, _ = _coupled_pre(inp, wide.cfg)
    carry = solver._init_batch(params, wide.base_B, wide.cfg)
    replay = solver._Replay(solver._traced(solver.make_step(params, wide.base_B, wide.cfg)[0], wide.cfg), carry)
    sync()
    t1 = time.perf_counter()
    replay.graph(solver.GRAPH_STEPS)
    sync()
    capture_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    replay_card_ms = cuda_ms(lambda: replay.advance(solver.GRAPH_STEPS), LAX_REPLAYS)
    replay_wall_ms = (time.perf_counter() - t1) * 1e3 / LAX_REPLAYS
    # the card's busy time a step, from torch.profiler traces (after the timed
    # runs, so that no tracing cost reaches them): a graphed segment's replay,
    # then LAX_TRACE_STEPS eager steps from the same inputs
    busy_ms, traced_ms, n_events = device_busy(lambda: replay.advance(solver.GRAPH_STEPS))
    assert n_events > 0, "the profiler recorded no activity on the card during a replay"
    wide_rec.update(capture_s=capture_s, graph_ms_per_step=replay_wall_ms / solver.GRAPH_STEPS,
                    graph_card_ms_per_step=replay_card_ms / solver.GRAPH_STEPS,
                    graph_device_ms_per_step=busy_ms / solver.GRAPH_STEPS,
                    graph_traced_ms_per_step=traced_ms / solver.GRAPH_STEPS,
                    graph_device_events=n_events, graph_device_busy_share=busy_ms / traced_ms)
    log(f"[13 lax graph] capture of {solver.GRAPH_STEPS} steps: {capture_s:.3f} s; {LAX_REPLAYS} replays: "
        f"{wide_rec['graph_ms_per_step']:.3f} ms/step on the host's clock, "
        f"{wide_rec['graph_card_ms_per_step']:.3f} between CUDA events; torch.profiler trace of one replay: "
        f"{n_events} events on the card, busy {wide_rec['graph_device_ms_per_step']:.3f} ms/step of "
        f"{wide_rec['graph_traced_ms_per_step']:.3f} traced: busy share {wide_rec['graph_device_busy_share']:.3f}")
    del replay
    sync()
    busy_ms, traced_ms, n_events = device_busy(
        lambda: solver._segment_batch_eager(params, wide.base_B, carry, wide.cfg, LAX_TRACE_STEPS))
    assert n_events > 0, "the profiler recorded no activity on the card"
    wide_rec.update(trace_steps=LAX_TRACE_STEPS, trace_device_events=n_events,
                    device_ms_per_step=busy_ms / LAX_TRACE_STEPS,
                    traced_ms_per_step=traced_ms / LAX_TRACE_STEPS, device_busy_share=busy_ms / traced_ms)
    log(f"[13 lax eager] torch.profiler trace of {LAX_TRACE_STEPS} eager steps: {n_events} events on the card, "
        f"busy {wide_rec['device_ms_per_step']:.3f} ms/step of {wide_rec['traced_ms_per_step']:.3f} ms/step on "
        f"the host's clock while traced: busy share {wide_rec['device_busy_share']:.3f}")
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

    # ---- (c) the device posterior on phase 15's trained system: its CUDA graphs against its eager
    # route and against the CPU; stretch and DRAM through each route
    post_args = mcmc.parser.parse_args([str(trained), "--data", "spt100", "--qois", *UQ_QOIS])
    fns, first_call_s = {}, {}
    for where in ("cpu", "cuda"):
        sys_ = System.load_from_file(trained, device=where)
        calib = [v for v in sys_.inputs() if v.category == "calibration"]
        d_args = (sys_, post_args, calib, [v.name for v in calib], *mcmc.build_dataset(sys_, post_args))
        if where == "cpu":
            fns["cpu"] = mcmc.build_device_posterior(*d_args)
        else:
            fns["eager"] = mcmc.build_device_posterior(*d_args, graphs=False)
            fns["graphs"] = mcmc.build_device_posterior(*d_args)
    lp_cpu = fns["cpu"][0](r5["draws"][:UQ_CHECK_THETAS])
    graph_diff = {}
    for W in UQ_GRAPH_WALKERS:
        theta = r5["draws"][:W]
        fns["eager"][0](theta)
        sync()
        t1 = time.perf_counter()
        lp_graph = fns["graphs"][0](theta)  # the first call with W: warm-up call, capture, replay
        first_call_s[W] = time.perf_counter() - t1
        lp_eager = fns["eager"][0](theta)
        other = np.roll(r5["draws"], 7, axis=0)[:W]
        again = fns["graphs"][0](other)  # the same graph, other thetas
        ref = fns["eager"][0](other)
        graph_diff[W] = max(float(np.max(np.abs(lp_graph - lp_eager) / np.abs(lp_eager))),
                            float(np.max(np.abs(again - ref) / np.abs(ref))))
        if W == UQ_CHECK_THETAS:
            lp_card = lp_graph
    assert np.all(np.abs(lp_cpu) < 1e29), lp_cpu  # every r5 draw lies in the domain
    post_err = float(np.max(np.abs(lp_card - lp_cpu) / np.abs(lp_cpu)))
    call_ms = {}
    for route in ("graphs", "eager"):
        wrapper = fns[route][0]
        wrapper(r5["draws"][:32])
        sync()
        t1 = time.perf_counter()
        for _ in range(50):
            wrapper(r5["draws"][:32])
        call_ms[route] = (time.perf_counter() - t1) / 50 * 1e3
    theta32 = torch.as_tensor(r5["draws"][:32], dtype=torch.float32, device=dev)
    n_ops = count_dispatches(lambda: fns["eager"][1].eager(theta32))
    n_ops_graph = count_dispatches(lambda: fns["graphs"][1](theta32))
    log(f"[16c posterior] {trained.name}, 17 parameters, QoIs {UQ_QOIS}: CUDA graphs vs the eager route at "
        f"{list(UQ_GRAPH_WALKERS)} walkers, max |diff| / |lp| "
        + ", ".join(f"{W}: {d:.3e}" for W, d in graph_diff.items())
        + f" (tolerance 0: bit for bit); the first call with each walker count (warm-up call, capture, replay) "
        + ", ".join(f"{W}: {t:.3f} s" for W, t in first_call_s.items())
        + f"; card vs CPU at {UQ_CHECK_THETAS} r5 draws, max |diff| / |lp| {post_err:.3e} (tolerance "
        f"{UQ_POSTERIOR_TOL:g}), lp in [{lp_cpu.min():.4e}, {lp_cpu.max():.4e}]; at 32 walkers x 23 conditions "
        f"{call_ms['graphs']:.3f} ms a call graphed ({32e3 / call_ms['graphs']:.0f} walker evaluations/s, "
        f"{n_ops_graph} aten operators dispatched), {call_ms['eager']:.3f} ms eager "
        f"({32e3 / call_ms['eager']:.0f} walker evaluations/s, {n_ops} aten operators dispatched, "
        f"{call_ms['eager'] * 1e3 / n_ops:.2f} us each)")
    assert all(d == 0.0 for d in graph_diff.values()), graph_diff
    assert post_err <= UQ_POSTERIOR_TOL and np.all(np.isfinite(lp_card)), (post_err, lp_card)
    rec["posterior"] = {"card_vs_cpu_rel_err": post_err, "tolerance": UQ_POSTERIOR_TOL,
                        "graphs_vs_eager_rel_diff": graph_diff, "first_call_s": first_call_s,
                        "ms_per_call_32_walkers": call_ms["graphs"], "ms_per_call_32_walkers_eager": call_ms["eager"],
                        "aten_ops_per_call": n_ops, "aten_ops_per_call_graphed": n_ops_graph}
    del fns, wrapper

    real_build = mcmc.build_device_posterior
    for sampler, walkers, iters in (("stretch", UQ_STRETCH_WALKERS, UQ_STRETCH_ITERS),
                                    ("dram", UQ_DRAM_WALKERS, UQ_DRAM_ITERS)):
        chains = {}
        for route in ("graphs", "eager"):
            calls: list = []  # (batch rows, seconds) of every log-posterior call

            def counted(*a, **k):
                np_fn, torch_fn = real_build(*a, graphs=route == "graphs", **k)

                def timed(theta):
                    t = time.perf_counter()
                    out = np_fn(theta)
                    calls.append((np.shape(theta)[0], time.perf_counter() - t))
                    return out

                return timed, torch_fn

            chain = build / f"{sampler}_{route}.npz"
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
            log(f"[16c {sampler} {route}] {walkers} walkers x {iters} iterations through mcmc.main on the card: "
                f"{wall:.3f} s in all, {len(calls)} log-posterior calls, batch sizes {dict(sizes)}, "
                f"{in_calls / len(calls) * 1e3:.3f} ms a call, {evals / in_calls:.0f} walker evaluations/s, "
                f"acceptance {acc:.3f}; chain {back.shape} read back from {chain.name}")
            assert calls and set(sizes) - {walkers} <= expect, sizes  # never the per-walker loop
            assert np.isfinite(samples).all() and np.isfinite(logps).all() and 0.0 < acc < 1.0, acc
            assert np.array_equal(back, samples) and np.array_equal(back_lp, logps)
            chains[route] = (samples, logps)
            rec[sampler if route == "graphs" else f"{sampler}_eager"] = {
                "walkers": walkers, "iterations": iters, "wall_s": wall, "calls": len(calls),
                "ms_per_call": in_calls / len(calls) * 1e3, "walker_evals_per_s": evals / in_calls,
                "acceptance": acc}
        same = all(np.array_equal(g, e) for g, e in zip(chains["graphs"], chains["eager"]))
        rec[sampler]["chain_equal_to_eager"] = same
        log(f"[16c {sampler}] the chain and its log-posteriors through the CUDA graphs "
            f"{'equal' if same else 'DIFFER FROM'} the eager route's")
        assert same, f"{sampler}: the graphed posterior's chain differs from the eager one's"

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


def study_phase(kstep_us: float) -> dict:
    """Phase 19: the SPT-100 physics studies of ``hallthrusterpem_tpu_torch/scripts``
    on the card, each through its ``main``; ``kstep_us`` is phase 6's µs a step.
    Returns the ``{"studies": ...}`` record, with each study's ``kstep`` launches."""
    import numpy as np
    import torch

    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.scripts import (_spt100, anchors, diagnose_breathing, diagnose_current,
                                                   kernel_bench, probe_anode_zone, probe_anom_shape, probe_uion,
                                                   tune_r5)

    t_phase = time.perf_counter()
    work = Path("build") / "studies"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rec: dict = {"launches": {}}
    finite = lambda *xs: bool(all(np.all(np.isfinite(np.asarray(x, dtype=np.float64))) for x in xs))

    def run(name, fn):
        """``fn()``, its seconds (to a sync) and its kstep launches, recorded under ``name``."""
        _kernels.reset_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall, n = time.perf_counter() - t0, _kernels.launch_counts["kstep"]
        rec["launches"][name] = n
        rec[name] = {"wall_s": wall, "kstep_launches": n}
        return result, wall, n

    # ---- (a) anchors, uncut: 10 conditions, B = 10, 2e-3 s; gated against the TPU artifact
    art, wall, n = run("anchors", lambda: anchors.main(["-o", str(work / "anchors.json")]))
    r5 = {c["name"]: c for c in json.loads(STUDY_R5_ANCHORS.read_text())["conditions"]}
    assert len(art["conditions"]) == 10 and {c["name"] for c in art["conditions"]} == set(r5), list(r5)
    scalar_dev, profile_ratio, misses = {}, {}, []
    for c in art["conditions"]:
        for q, v in c["qois"].items():
            ref = r5[c["name"]]["qois"][q]
            if "model" in v:
                assert math.isfinite(v["model"]), (c["name"], q, v)
                scalar_dev[f"{c['name']}.{q}"] = abs(v["model"] - ref["model"]) / abs(ref["model"])
                line = f"model {v['model']:.5g} (r5 {ref['model']:.5g}), error {v['rel_err']:.4f}"
            else:
                assert math.isfinite(v["rel_l2"]), (c["name"], q, v)
                profile_ratio[c["name"]] = v["rel_l2"] / ref["rel_l2"]
                line = f"rel-L2 {v['rel_l2']:.4f} (r5 {ref['rel_l2']:.4f})"
            if not v["pass"]:
                misses.append(f"{c['name']}.{q}")
            log(f"[19a anchors]   {c['name']:30s} {q:6s} {line}, tolerance {v['tol']:g}: "
                f"{'pass' if v['pass'] else 'MISS'}")
    median_dev = float(np.median(list(scalar_dev.values())))
    worst = max(scalar_dev, key=scalar_dev.get)
    rec["anchors"].update(
        conditions=len(art["conditions"]), table_pass=art["pass"], table_misses=misses,
        device=art["device"], power_limit=art["power_limit"], median_scalar_dev_vs_r5=median_dev,
        max_scalar_dev_vs_r5=scalar_dev[worst], max_scalar_dev_qoi=worst, profile_ratio_vs_r5=profile_ratio)
    log(f"[19a anchors] {len(art['conditions'])} conditions, B=10, 2e-3 s: {wall:.2f} s, {n} kstep launches; "
        f"against runs/r5/anchors.json (TPU): scalar QoIs median deviation {median_dev:.4f} (tolerance "
        f"{STUDY_MEDIAN_TOL:g}), largest {scalar_dev[worst]:.4f} at {worst} (tolerance {STUDY_EACH_TOL:g}), "
        f"profile rel-L2 ratios " + ", ".join(f"{k} {v:.3f}" for k, v in profile_ratio.items())
        + f" (band {STUDY_PROFILE_GATE}); the table's own verdict: {'PASS' if art['pass'] else 'FAIL'}"
        + (f", missed {misses}" if misses else ""))
    assert median_dev <= STUDY_MEDIAN_TOL and scalar_dev[worst] <= STUDY_EACH_TOL, scalar_dev
    lo, hi = STUDY_PROFILE_GATE
    assert all(lo <= r <= hi for r in profile_ratio.values()), profile_ratio

    # ---- (b) tune_r5 -n 256, uncut: 768 rows at 2e-3 s in one batch
    res, wall, n = run("tune_r5", lambda: tune_r5.main(["-n", str(STUDY_TUNE_N),
                                                         "-o", str(work / "tune_nominals.json")]))
    out = res["out"]
    n_rows = int(out["thrust"].shape[0])
    ok = np.isfinite(out["thrust"]) & np.isfinite(out["discharge_current"]) & np.isfinite(out["ion_current"])
    r5t = json.loads(STUDY_R5_TUNE.read_text())
    assert (r5t["frac"], r5t["width"], r5t["wall_recycling"]) == (0.55, 1.5e-3, 0.93), r5t["box"]
    assert r5t["box"] == {k: list(v[:2]) for k, v in tune_r5.BOX.items()}, r5t["box"]
    ours = {r["idx"]: r for r in res["rows"]}
    devs, both = [], 0
    for r in r5t["rows"]:
        o = ours.get(r["idx"]) if r["idx"] < STUDY_TUNE_N else None
        if o is None or not (math.isfinite(o["score"]) and math.isfinite(r["score"])):
            continue
        assert all(o[k] == r[k] for k in tune_r5.BOX), (o, r)
        both += 1
        devs += [abs(o[f"{q}_err"] - r[f"{q}_err"]) / (1 + r[f"{q}_err"]) for q in ("T", "I_d", "I_B0", "eta_m")]
        devs += [abs(a - b) / b for a, b in zip(o["uion_rel_l2"], r["uion_rel_l2"])]
    tune_dev = float(np.median(devs))
    sim_ms = n_rows * _spt100.DURATION * 1e3
    best = res["rows"][0]
    rec["tune_r5"].update(rows=n_rows, finite_rows=int(ok.sum()), solve_s=res["wall_s"],
                          sim_ms_per_s=sim_ms / res["wall_s"], rows_per_s=n_rows / res["wall_s"],
                          finite_scores=sum(math.isfinite(r["score"]) for r in res["rows"]),
                          candidates_vs_r5=both, median_table_dev_vs_r5=tune_dev,
                          best={k: best[k] for k in ("idx", "T_err", "I_d_err", "I_B0_err", "eta_m_err",
                                                     "uion_rel_l2", "score")})
    log(f"[19b tune_r5] -n {STUDY_TUNE_N}: {n_rows} rows at {_spt100.DURATION:g} s in {res['wall_s']:.2f} s "
        f"({sim_ms / res['wall_s']:.2f} sim-ms/s, {n_rows / res['wall_s']:.2f} rows/s), {n} kstep launches, "
        f"finite rows {int(ok.sum())}/{n_rows} (floor {STUDY_TUNE_FINITE:.0%}); {both} candidates finite here and "
        f"in runs/r5/tune_b_w093.json's best 50: median table deviation {tune_dev:.4f} (tolerance "
        f"{STUDY_MEDIAN_TOL:g}); best here idx {best['idx']}, score {best['score']:.3f}")
    assert ok.mean() >= STUDY_TUNE_FINITE and both > 0 and tune_dev <= STUDY_MEDIAN_TOL, (ok.mean(), both, tune_dev)

    # ---- (c) probe_uion, diagnose_current, probe_anom_shape, probe_anode_zone at their full 2e-3 s
    rep, wall, n = run("probe_uion", lambda: probe_uion.main(["-o", str(work / "uion_probe")]))
    rec["probe_uion"]["rel_l2"] = [e["rel_l2"] for e in rep]
    assert len(rep) == 3 and finite([e["rel_l2"] for e in rep], [e["u_model"] for e in rep]), rep
    cur, wall, n = run("diagnose_current", lambda: diagnose_current.main([]))
    o = cur["out"]
    rec["diagnose_current"].update(steps=cur["cfg"].num_steps, T=float(o["thrust"]),
                                   I_d=float(o["discharge_current"]), I_B0=float(o["ion_current"]))
    assert finite(o["thrust"], o["discharge_current"], o["ion_current"], o["ne"], o["Tev"]), o["thrust"]
    anom, wall, n = run("probe_anom_shape", lambda: probe_anom_shape.main(["-o", str(work / "anom_shape")]))
    rows_ok = [finite(c["uion_rel_l2"], c["T_rel_err"], c["I_d_rel_err"], c["I_B0_rel_err"]) for c in anom["cases"]]
    rec["probe_anom_shape"]["finite_rows"] = f"{sum(rows_ok)}/{len(rows_ok)}"
    assert any(rows_ok), anom["cases"]
    zone, wall, n = run("probe_anode_zone", lambda: probe_anode_zone.main(["-o", str(work / "anode_zone.json")]))
    rows_ok = [finite(c["uion_rel_l2"][i]) for c in zone for i in range(3)]
    rec["probe_anode_zone"]["finite_rows"] = f"{sum(rows_ok)}/{len(rows_ok)}"
    assert any(rows_ok), zone
    for name in ("probe_uion", "diagnose_current", "probe_anom_shape", "probe_anode_zone"):
        r = rec[name]
        log(f"[19c {name}] {r['wall_s']:.2f} s, {r['kstep_launches']} kstep launches"
            + (f", finite rows {r['finite_rows']}" if "finite_rows" in r else ""))
        assert r["kstep_launches"] > 0, name

    # ---- (d) diagnose_breathing at its defaults through the K-step route; a short lax-route run
    br, wall, n = run("diagnose_breathing", lambda: diagnose_breathing.main([]))
    cfg = br["cfg"]
    rec["diagnose_breathing"].update(route=br["route"], steps=cfg.num_steps, snapshots=br["stats"]["n_snap"],
                                     stats=br["stats"])
    log(f"[19d diagnose_breathing] route {br['route']}, {cfg.num_cells} cells, {cfg.ncharge} charge state(s), "
        f"{cfg.num_steps} steps: {wall:.2f} s, {n} kstep launches, {br['stats']['n_snap']} snapshots; dominant "
        f"frequency {br['stats'].get('dominant_kHz', float('nan')):.1f} kHz, I_B mean {br['stats']['I_B']['mean']:.3f} A")
    every = diagnose_breathing.parser.get_default("every")
    assert br["route"] == "kstep" and n == br["stats"]["n_snap"] * every // fs.INNER_STEPS, (br["route"], n)
    assert finite(*br["snaps"].values())
    lax, wall, n = run("diagnose_breathing_lax", lambda: diagnose_breathing.main(STUDY_LAX_BREATHING))
    rec["diagnose_breathing_lax"].update(route=lax["route"], steps=lax["cfg"].num_steps,
                                         snapshots=lax["stats"]["n_snap"])
    log(f"[19d diagnose_breathing] {' '.join(STUDY_LAX_BREATHING)}: route {lax['route']}, "
        f"{lax['stats']['n_snap']} snapshots of 7 steps, {wall:.2f} s, {n} kstep launches")
    assert lax["route"] == "lax" and n == 0 and finite(*lax["snaps"].values())

    # ---- (e) kernel_bench at B = 1024, 20,000 steps: CUDA events around each run, after a
    # warm-up; then the same run launch by launch, an event between launches
    bench_b, bench_steps = STUDY_BENCH
    kb, wall, n = run("kernel_bench", lambda: kernel_bench.main([str(bench_b), str(bench_steps)]))
    cfg, params, base_B = kernel_bench.bench_inputs(bench_b, bench_steps, torch.device("cuda", 0))
    consts, state, prof, sacc = fs.init_carry(params, base_B, cfg)
    K = fs.INNER_STEPS
    events = [torch.cuda.Event(enable_timing=True) for _ in range(math.ceil(bench_steps / K) + 1)]
    events[0].record()
    for j, i0 in enumerate(range(0, bench_steps, K)):
        fs.kstep(state, prof, sacc, consts, i0, K, cfg, None)
        events[j + 1].record()
    torch.cuda.synchronize()
    per_launch = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    us = lambda ms: ms / K * 1e3
    run_us, first_us, last_us = (us(float(np.mean(x))) for x in (per_launch, per_launch[:20], per_launch[-20:]))
    failed = float((sacc[:, fs.A_FAILED] > 0.5).float().mean())
    rec["kernel_bench"].update(batch=bench_b, steps=bench_steps, launches_a_run=kb["launches"],
                               us_per_step=kb["us_per_step"], reps=kb["reps"], phase6_us_per_step=kstep_us,
                               ratio_to_phase6=kb["us_per_step"] / kstep_us, per_launch_us_per_step=run_us,
                               first_20_launches_us_per_step=first_us, last_20_launches_us_per_step=last_us,
                               failed_rows_at_end=failed)
    log(f"[19e kernel_bench] B={bench_b}, {bench_steps} steps, {kb['launches']} launches a run: "
        f"{kb['us_per_step']:.2f} us/step (least of {len(kb['reps'])}; finite rows {kb['reps'][-1]['finite']:.2f}), "
        f"{kb['us_per_step'] / kstep_us:.4f}x phase 6's {kstep_us:.2f}; the same run launch by launch: "
        f"{run_us:.2f} us/step (tolerance {STUDY_BENCH_TOL:g} against the run's), the first 20 launches "
        f"{first_us:.2f} (all rows healthy, as in phase 6: tolerance {STUDY_BENCH_TOL:g} against phase 6), "
        f"the last 20 {last_us:.2f} with {failed:.0%} of the rows failed")
    assert n == len(kb["reps"]) * kb["launches"] == len(kb["reps"]) * len(per_launch), (n, kb["launches"])
    assert abs(kb["us_per_step"] / run_us - 1) <= STUDY_BENCH_TOL, (kb["us_per_step"], run_us)
    assert abs(first_us / kstep_us - 1) <= STUDY_BENCH_TOL, (first_us, kstep_us)

    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[19 studies] done ({rec['wall_s']:.2f} s)")
    return rec


def parity_sweep_phase() -> dict:
    """Phase 20: (a) ``parity_tpu`` on the card, B = ``PARITY_BATCH``: (i) every
    config over ~1,100 steps (``PARITY_SHORT``), the lax solver's CUDA graphs
    against the K-step kernel through ``parity_tpu.solve``, equal finite masks
    and T, I_d, I_B0 within ``QOI_RTOL``; (ii) ``parity_tpu.run_config`` on
    ``PARITY_FIRST`` at the cut horizon ``PARITY_DURATION``, the script's own
    verdicts recorded beside (iii) the same scoring of the kernel against
    itself with V_a ``PARITY_ULP`` apart; (b) ``gen_mlp_data`` labels
    ``SWEEP_ROWS`` rows through ``kstep`` into ``build/sweep/``, then
    ``mlp_sweep`` fits ``SWEEP_VARIANTS`` at their own widths, their steps cut
    to ``SWEEP_STEPS``, scored on r5's test set, and the saved best reloads bit
    for bit. Returns the ``{"parity_sweep": ...}`` record."""
    import numpy as np
    import torch

    from hallthrusterpem_tpu_torch.core.json_loader import config_dir, load_system
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.scripts import gen_mlp_data, mlp_sweep, parity_tpu

    t_phase = time.perf_counter()
    dev, sync, B = torch.device("cuda", 0), torch.cuda.synchronize, PARITY_BATCH
    rec: dict = {"parity": {"batch": B, "short": {}, "duration_s": PARITY_DURATION, "uncut_duration_s": 2e-3,
                            "configs": [], "kstep_twins": []},
                 "launches": {"parity": 0, "parity_two_group": 0}}

    def count(cond, n):
        rec["launches"]["parity_two_group" if cond.get("neutral_groups") == 2 else "parity"] += n

    # ---- (a)(i) every config over ~1,100 steps: the two routes before chaos sets in
    for cond in parity_tpu.CONFIGS:
        lax_out, lax_s, steps, _ = parity_tpu.solve(cond, "lax", B, 11, device=dev, duration=PARITY_SHORT)
        kern_out, _, _, launches = parity_tpu.solve(cond, "kstep", B, 11, device=dev, duration=PARITY_SHORT)
        count(cond, launches)
        fin = np.isfinite(lax_out["T"])
        assert np.array_equal(fin, np.isfinite(kern_out["T"])) and fin.any(), cond["name"]
        err = max(float(np.max(np.abs(kern_out[q] - lax_out[q])[fin] / np.abs(lax_out[q])[fin]))
                  for q in ("T", "I_d", "I_B0"))
        rec["parity"]["short"][cond["name"]] = {"steps": steps, "finite": int(fin.sum()), "max_rel": err,
                                                "lax_s": lax_s, "kstep_launches": launches}
        log(f"[20a parity short] {cond['name']}: {steps} steps ({PARITY_SHORT:g} s), B={B}: lax (CUDA graphs, "
            f"{lax_s:.2f} s with the capture) against kstep ({launches} launches): finite {int(fin.sum())}/{B} in "
            f"both, T/I_d/I_B0 max relative difference {err:.3e} (tolerance {QOI_RTOL:g})")
        assert err < QOI_RTOL, (cond["name"], err)

    # ---- (a)(ii)-(iii) run_config at the cut horizon, and the kernel against itself one ulp apart
    inputs_for = parity_tpu.inputs_for

    def shifted(cond, batch, seed):
        x = inputs_for(cond, batch, seed)
        return dict(x, V_a=x["V_a"] * (1 + PARITY_ULP))

    line = lambda e: (f"finite {e['finite']['lax']}/{e['finite']['pallas']}, mask agreement "
                      f"{e['finite']['mask_agreement']} (floor {parity_tpu.MIN_MASK_AGREEMENT}), attractor agreement "
                      f"{e['finite']['attractor_agreement']} (floor {parity_tpu.MIN_ATTRACTOR_AGREEMENT}); " + "; ".join(
                          f"{q} median/p90/max {r['median_rel']:.2e}/{r['p90_rel']:.2e}/{r['max_rel']:.2e} (tolerances "
                          f"{r['tol_median']:g}/{r['tol_p90']:g}/{r['tol_max']:g})" for q, r in e["qois"].items())
                      + f": pass={e['pass']}")
    for cond in (c for c in parity_tpu.CONFIGS if c["name"] in PARITY_FIRST):
        entry = parity_tpu.run_config(cond, B, 11, device=dev, duration=PARITY_DURATION)
        rec["parity"]["configs"].append(entry)
        count(cond, entry["kstep_launches"])
        log(f"[20a parity] {cond['name']}: run_config at {PARITY_DURATION:g} s (uncut 2e-3 s) = {entry['steps']} "
            f"steps, B={B}: lax (CUDA graphs) {entry['wall_s']['lax']:.2f} s = {entry['lax_ms_per_step']:.3f} "
            f"ms/step, kstep {entry['wall_s']['pallas']:.2f} s in {entry['kstep_launches']} launches; " + line(entry))
        assert entry["kstep_launches"] > 0 and entry["finite"]["both"] > 0, entry
        a = parity_tpu.solve(cond, "kstep", B, 11, device=dev, duration=PARITY_DURATION)
        parity_tpu.inputs_for = shifted
        try:
            b = parity_tpu.solve(cond, "kstep", B, 11, device=dev, duration=PARITY_DURATION)
        finally:
            parity_tpu.inputs_for = inputs_for
        count(cond, a[3] + b[3])
        twins = parity_tpu.score(cond, B, 11, a[0], b[0])
        rec["parity"]["kstep_twins"].append(twins)
        log(f"[20a parity] {cond['name']}: the same scoring of kstep against kstep with V_a {PARITY_ULP:g} apart: "
            + line(twins))
    log(f"[20a parity] horizon cut to {PARITY_DURATION:g} s of 2e-3 s, configs {list(PARITY_FIRST)} of "
        f"{len(parity_tpu.CONFIGS)}: the script's verdicts are recorded, not gated (at a cut horizon the kernel "
        f"misses them against itself too); gated: the ~1,100-step agreement above ({time.perf_counter() - t_phase:.2f} s)")

    # ---- (b) gen_mlp_data through kstep, then mlp_sweep on r5's test set
    t0 = time.perf_counter()
    work = Path("build") / "sweep"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    shutil.copy(config_dir() / "pem_v0_SPT-100_compression.json", work)
    (work / "test_set.pkl").symlink_to((Path("runs") / "r5" / "surr" / "test_set.pkl").resolve())
    _kernels.reset_counts()
    cache = gen_mlp_data.main(["-n", str(SWEEP_ROWS), "--seed", "1", "--chunk", str(SWEEP_ROWS),
                               "--dir", str(work)])
    sync()
    gen_s, gen_launches = time.perf_counter() - t0, _kernels.launch_counts["kstep"]
    with open(cache, "rb") as fd:
        done_rows = pickle.load(fd)["done"]
    rec["gen_mlp_data"] = {"rows": SWEEP_ROWS, "done": done_rows, "wall_s": gen_s, "rows_per_s": SWEEP_ROWS / gen_s,
                           "kstep_launches": gen_launches}
    rec["launches"]["gen_mlp_data"] = gen_launches
    log(f"[20b gen_mlp_data] {SWEEP_ROWS} rows (r5: ~49k), the Thruster at its own 2e-3 s: {gen_s:.3f} s "
        f"({SWEEP_ROWS / gen_s:.1f} rows/s), {gen_launches} kstep launches")
    assert gen_launches > 0 and done_rows == SWEEP_ROWS
    variants = mlp_sweep.VARIANTS
    mlp_sweep.VARIANTS = [dict(v, steps=SWEEP_STEPS) for v in variants]
    try:
        t0 = time.perf_counter()
        results, (best, surr) = mlp_sweep.main(["--dir", str(work), "--variants", *SWEEP_VARIANTS,
                                                "-o", str(work / "mlp_sweep.json"), "--save-best"])
        sync()
        sweep_s = time.perf_counter() - t0
    finally:
        mlp_sweep.VARIANTS = variants
    assert [r["name"] for r in results] == list(SWEEP_VARIANTS), results
    for r in results:
        cut = next(v for v in variants if v["name"] == r["name"])["steps"]
        log(f"[20b mlp_sweep] {r['name']}: {r['hidden']} x {r['ensemble']}, {r['steps']} steps (uncut {cut}), "
            f"{r['wall_s']} s, val_rmse {r['val_rmse']:.4f}, rel-L2 on r5's test set "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(r["rel_l2"].items())))
        assert math.isfinite(r["val_rmse"]) and r["rel_l2"] and all(
            math.isfinite(v) for v in r["rel_l2"].values()), r
    xt, _ = mlp_sweep.load_test_set(work / "test_set.pkl")
    reloaded = load_system(work / "pem_v0_SPT-100_trained.json", device=dev).system_surrogate
    mine, again = surr.predict(xt), reloaded.predict(xt)
    same = all(same_bits(mine[k], again[k]) for k in mine)
    rec["mlp_sweep"] = {"variants": results, "best": best, "wall_s": sweep_s, "steps": SWEEP_STEPS,
                        "reload_bit_equal": same}
    log(f"[20b mlp_sweep] best {best}; the saved best reloads and predicts r5's {len(next(iter(xt.values())))} "
        f"test rows {'bit for bit alike' if same else 'DIFFERENTLY'}; sweep {sweep_s:.2f} s")
    assert same, "the saved best ensemble does not reload bit for bit"
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[20] done ({rec['wall_s']:.2f} s)")
    return rec


def bench_phase(kstep_ms: float) -> dict:
    """Phase 21: ``python -m hallthrusterpem_tpu_torch.bench`` with its defaults
    as a child process; ``kstep_ms`` is phase 6's ms a launch. Returns the
    ``{"bench": ...}`` record."""
    import os

    import torch

    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.pem import CoupledPEM

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # leave the card's memory to the child
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "hallthrusterpem_tpu_torch.bench"], capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT, env=env, cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines()[-5:]:
        log(f"[21 bench] stderr: {line}")
    assert proc.returncode == 0, f"the bench exited with {proc.returncode}: {proc.stdout[-2000:]}"
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    finite = re.search(r"(\d+)/(\d+) finite", proc.stderr)
    runs = re.search(r"(\d+) steps, kstep launches per timed run \[(\d+), (\d+)\]", proc.stderr)
    assert finite and runs, proc.stderr[-2000:]
    n_ok, batch = int(finite.group(1)), int(finite.group(2))
    steps, launches = int(runs.group(1)), [int(runs.group(2)), int(runs.group(3))]
    duration = 5e-4  # the bench's default
    assert steps == CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=duration, device="cuda").cfg.num_steps
    expect = math.ceil(steps / fs.INNER_STEPS)
    predicted = batch * duration * 1e3 / (expect * kstep_ms / 1e3)
    ratio = line["value"] / predicted if line["value"] is not None else float("nan")
    log(f"[21 bench] {json.dumps(line)}; {n_ok}/{batch} rows finite, {steps} steps, kstep launches per timed "
        f"run {launches} (ceil(steps / {fs.INNER_STEPS}) = {expect}); phase 6's {kstep_ms:.4f} ms a launch "
        f"predicts {predicted:.3f} sim-ms/s: measured / predicted {ratio:.4f} (gate {BENCH_GATE}); the child "
        f"process took {wall:.2f} s")
    assert list(line) == ["metric", "value", "unit", "vs_baseline"], line
    assert line["metric"] == "coupled_pem_sim_ms_per_sec_per_chip" and math.isfinite(line["value"]), line
    assert batch == 1024 and n_ok >= BENCH_FINITE, (n_ok, batch)
    assert launches == [expect, expect], (launches, expect)
    assert BENCH_GATE[0] <= ratio <= BENCH_GATE[1], ratio
    return {"line": line, "finite_rows": n_ok, "batch": batch, "steps": steps, "kstep_launches": launches,
            "predicted_sim_ms_per_s": predicted, "measured_over_predicted": ratio, "child_wall_s": wall}


def plume_inputs(rows: int, case: str, seed: int) -> dict:
    """The plume's System inputs for ``rows`` rows on the card: drawn from the
    pem_v0 SPT-100 distributions, with I_B0 and T as the Thruster gives them and
    every eighth row NaN in both (a row the Thruster masked). ``case``:
    ``float32`` or ``float64`` for every input, or ``mixed``: I_B0 and T in
    float64 and the rest float32, as the Thruster gives them once a row is
    masked."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = {"P_b": 10 ** rng.uniform(-8, -4, rows), "c0": rng.uniform(0, 1, rows),
         "c1": rng.uniform(0.1, 1, rows), "c2": rng.uniform(-15, 15, rows),
         "c3": rng.uniform(0.2, np.pi / 2, rows), "c4": 10 ** rng.uniform(18, 22, rows),
         "c5": 10 ** rng.uniform(14, 18, rows), "sigma_cex": rng.uniform(51e-20, 58e-20, rows),
         "I_B0": rng.uniform(2, 5, rows), "T": rng.uniform(0.04, 0.1, rows)}
    x["I_B0"][::8] = x["T"][::8] = np.nan
    wide = ("I_B0", "T") if case == "mixed" else ()
    dtype = torch.float64 if case == "float64" else torch.float32
    return {k: torch.as_tensor(v, dtype=torch.float64 if k in wide else dtype, device="cuda")
            for k, v in x.items()}


def plume_phase() -> dict:
    """Phase 22: the plume's kernel against its plain version and timed, at
    each of ``PLUME_ROWS``; returns its entry of the kernels line."""
    import torch

    from hallthrusterpem_tpu_torch.models import plume

    t0 = time.perf_counter()
    rec = {"name": "plume", "route": "cuda", "source": PLUME_SOURCE,
           "replaces": "none: the plume's eager version made ~1,300 launches a call",
           "scaled_err_tolerance": PLUME_TOL, "div_angle_tolerance_float32": PLUME_DIV_TOL_F32,
           "library_ms": None, "rows": {}}
    for rows in PLUME_ROWS:
        for case in ("float32", "float64", "mixed"):
            x = plume_inputs(rows, case, seed=rows)
            plume.current_density(x)  # the grid on this card
            plume.reset_counts()
            got = plume.current_density(x)
            ref = plume.current_density_plain(x)
            torch.cuda.synchronize()
            assert plume.launch_counts["plume"] == 1, plume.launch_counts
            errs = {}
            assert set(got) == set(ref) and "T_c" in ref, (sorted(got), sorted(ref))
            for k, r in ref.items():
                assert got[k].dtype == r.dtype and got[k].shape == r.shape, (rows, case, k, got[k].dtype, r.dtype)
                fin = torch.isfinite(r)
                assert torch.equal(torch.isfinite(got[k]), fin), (rows, case, k)
                errs[k] = scaled_err(got[k][fin], r[fin])
                tol = PLUME_DIV_TOL_F32 if (k == "div_angle" and r.dtype == torch.float32) else PLUME_TOL
                assert errs[k] < tol, (rows, case, k, errs[k])
            label = f"{rows}_{case}"
            entry = {"max_scaled_err": errs, "T_c_dtype": str(got["T_c"].dtype)}
            if case == "float32":
                ms = cuda_ms(lambda: plume.current_density(x), PLUME_REPS, lead=True)
                torch.cuda._sleep(LEAD_CYCLES)
                t1 = time.perf_counter()
                for _ in range(PLUME_REPS):
                    plume.current_density(x)
                host_us = (time.perf_counter() - t1) / PLUME_REPS * 1e6
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(5):
                    plume.current_density_plain(x)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t1) / 5 * 1e3
                ops = count_ops(lambda: plume.current_density_plain(x))
                n_bytes = 4 * (rows * (10 + 91 + 2) + 4 * 91)  # inputs, j_ion, div_angle and T_c, the grid
                ops_ms, bytes_ms = ops / H100_F32_FLOPS * 1e3, n_bytes / H100_BYTES_PER_S * 1e3
                entry.update(ms=ms, host_us=host_us, plain_ms=plain_ms,
                             plain_operators=count_dispatches(lambda: plume.current_density_plain(x)),
                             ops=ops, bytes=n_bytes, bound_ms=max(ops_ms, bytes_ms),
                             bound_by="operations" if ops_ms >= bytes_ms else "bytes")
                log(f"[22 plume] B={rows}: {ms * 1e3:.2f} us a launch on the card (back to back), "
                    f"{host_us:.1f} us of host time a call, bound {entry['bound_ms'] * 1e3:.3f} us "
                    f"({entry['bound_by']}: {ops:.3e} ops, {n_bytes:.3e} bytes); plain {plain_ms:.2f} ms "
                    f"a call, {entry['plain_operators']} operators")
            log(f"[22 plume] B={rows} {case}: 1 launch, T_c {got['T_c'].dtype}, max scaled error "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            rec["rows"][label] = entry
    main_row = rec["rows"][f"{PLUME_ROWS[-1]}_float32"]
    rec.update({k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, launches=1)
    log(f"[22 plume] done ({time.perf_counter() - t0:.2f} s)")
    return rec


def h9_phase() -> dict:
    """Phase 23: the H9-class system through ``System.predict`` at one call of
    the benchmark's facility sweep (see the module's note)."""
    import numpy as np
    import torch

    from hallthrusterpem_tpu_torch import tracing
    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from pembench.traffic import Traffic, load_mix

    t0 = time.perf_counter()
    dev, path = torch.device("cuda"), Path(__file__).resolve().parent / H9_CONFIG
    doc = json.loads(path.read_text())
    system = load_system(path, device=dev)
    rows = Traffic(doc, load_mix(H9_MIX), H9_SEED).call(0)
    first, launch = {}, fs.kstep

    def watched(state, prof, sacc, consts, i0, K, cfg, physics=None):
        """The kernel; its first launch also against the plain version from the same carry."""
        if first:
            return launch(state, prof, sacc, consts, i0, K, cfg, physics)
        carry = tuple(x.clone() for x in (state, prof, sacc))
        launch(state, prof, sacc, consts, i0, K, cfg, physics)
        fs.kstep_plain(*carry, consts, i0, K, cfg, fs.Physics(cfg))
        first.update(cfg=cfg, K=K, flags=_kernels.kernel_params(cfg), errs=carry_errs(fs, (state, prof, sacc), carry),
                     circuit=float(consts["scalars"][:, [fs.P_RC, fs.P_LDT]].abs().max()))

    _kernels.reset_counts()
    before = dict(tracing.counts)
    fs.kstep = watched
    try:
        out = system.predict(rows, use_model=doc["use_model"])
        torch.cuda.synchronize()
    finally:
        fs.kstep = launch
    change = {k: tracing.counts[k] - before[k] for k in tracing.counts}
    cfg, flags, (err, abs_err, n_arrays) = first["cfg"], first["flags"], first["errs"]
    launches, expected = _kernels.launch_counts["kstep"], math.ceil(cfg.num_steps / first["K"])
    kname = f"kstep<{cfg.ncharge},{cfg.neutral_groups}>"
    branch = {"ion_wall": flags.ion_wall, "solve_plume": flags.solve_plume, "div_corr": flags.div_corr,
              "trace": flags.trace, "circuit_max": first["circuit"]}
    assert kname == "kstep<3,1>" and cfg.num_cells == 200 and cfg.anom_model == "GaussianBohm", (kname, cfg)
    assert cfg.pressure_shift == "SimpleLogisticShift", cfg.pressure_shift
    assert branch == {"ion_wall": 0, "solve_plume": 0, "div_corr": 0, "trace": 1, "circuit_max": 0.0}, branch
    assert launches == expected, (launches, expected)
    assert err < STATE_RTOL, err
    n = len(rows["P_b"])
    assert change["gaussian_bohm_rows"] == change["plume_kernel_rows"] == change["rows_attempted"] == n, change
    finite = torch.isfinite(out["T"]).cpu().numpy()
    by_pressure = {f"{p:g}": float(finite[rows["P_b"] == p].mean()) for p in np.unique(rows["P_b"])}
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    system.predict(rows, use_model=doc["use_model"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = int(torch.cuda.max_memory_allocated())
    log(f"[23 H9] {H9_CONFIG}, {n} rows ({H9_MIX}, seed {H9_SEED}): {kname}, {cfg.num_cells} cells, dt "
        f"{cfg.dt:.4e} s, {cfg.num_steps} steps, {launches} launches (expected {expected}); flags {branch}; first "
        f"launch vs {first['K']} plain steps: max scaled error {err:.3e} (tolerance {STATE_RTOL:g}), max absolute "
        f"{abs_err:.3e} over {n_arrays} arrays; finite share by P_b {by_pressure}; counters {change}; a second call "
        f"{wall:.3f} s, peak {peak / 1e6:.1f} MB ({time.perf_counter() - t0:.2f} s)")
    return {"rows": n, "kernel": kname, "dt": cfg.dt, "steps": cfg.num_steps, "launches": launches,
            "flags": branch, "first_launch_max_scaled_err": err, "first_launch_max_abs_err": abs_err,
            "finite_share_by_P_b": by_pressure, "counters": change, "wall_s": wall, "peak_bytes": peak}


def width_phase() -> dict:
    """Phase 24: ``kstep<3,1>`` at fidelity (2,2) on its 224 lanes (the instance
    bounded at 224 threads) against the same launches forced onto 256 lanes
    (the instance bounded at 256, which every width ran before the layout was
    sized to the warp): the outputs on lanes 0..NC-1 and every accumulator
    bit for bit after one launch; ms a K = 50 launch at each batch of
    ``WIDTH_BATCHES``, back to back after the one spin, each width timed twice
    (``WIDTH_ORDER``) from the same carry; each instance's registers and spill
    bytes (ptxas) and its barriers and static instructions a warp-step (SASS),
    ``kstep<1,1>``'s at 128 lanes beside them; then where the warps of four
    co-resident 224-thread blocks sit on an SM's four schedulers."""
    import ctypes

    import torch

    from hallthrusterpem_tpu_torch import kernel_build
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.pem import CoupledPEM, _coupled_pre, default_coupled_inputs

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    kernel_build.build_all()
    _kernels.load_libraries()
    info = _kernels.build_info["kstep"]
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=2e-5, device=dev)
    low = CoupledPEM(thruster="SPT-100", model_fidelity=(0, 0), duration=2e-5, device=dev)
    cfg, K, narrow = pem.cfg, fs.INNER_STEPS, fs.lanes_for(pem.cfg)
    assert (cfg.ncharge, cfg.neutral_groups, narrow, fs.lanes_for(low.cfg)) == (3, 1, 224, 128)
    code = {}
    for label, c, lanes in (("kstep<3,1> on 224", cfg, 224), ("kstep<3,1> on 256", cfg, 256),
                            ("kstep<1,1> on 128", low.cfg, 128)):
        mangled = kstep_mangled(c.ncharge, c.neutral_groups, lanes)
        sass = kernel_sass(info["path"], mangled)
        barriers, insns = step_loop_counts(sass, _kernels.kernel_params(c).n_levels)
        code[label] = dict(ptxas_usage(info["log"], mangled), barriers_per_step=barriers,
                           instructions_per_warp_step=insns, sass_instructions=len(sass))
        log(f"[24 width] {label}: {code[label]}")

    widen = lambda x, lanes: torch.nn.functional.pad(x, (0, lanes - x.shape[-1])).contiguous()
    ms, equal = {}, {}
    for batch, reps in WIDTH_BATCHES.items():
        x = default_coupled_inputs(batch, torch.Generator().manual_seed(24), spread=0.08, device=dev)
        params, _ = _coupled_pre(x, cfg)
        consts, state, prof, sacc = fs.init_carry(params, pem.base_B, cfg)
        after = {}
        for lanes in WIDTH_ORDER:
            c = dict(consts, nu_anom=widen(consts["nu_anom"], lanes), omega_ce=widen(consts["omega_ce"], lanes))
            carry = [widen(state, lanes), widen(prof, lanes), sacc.clone()]
            launch = lambda: _kernels.kstep_cuda(*carry, c, 0, K, cfg)
            launch()
            torch.cuda.synchronize()
            after.setdefault(lanes, [t[..., :cfg.nc].clone() for t in carry[:2]] + [carry[2].clone()])
            ms.setdefault(batch, {}).setdefault(lanes, []).append(cuda_ms(launch, reps, lead=True))
        equal[batch] = all(torch.equal(a, b) for a, b in zip(after[224], after[256]))
        t = {k: min(v) for k, v in ms[batch].items()}
        log(f"[24 width] B={batch}, K={K}: {t[224]:.4f} ms a launch on 224 lanes, {t[256]:.4f} on 256 "
            f"({t[224] / t[256] - 1:+.2%}; every timing {ms[batch]}); lanes 0..NC-1 and the accumulators "
            f"after one launch equal bit for bit: {equal[batch]}")
        assert equal[batch], batch
        del params, consts, state, prof, sacc, carry, after

    src = Path("build") / "probe" / "probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_SOURCE)
    lib_path = src.with_suffix(".so")
    subprocess.run([shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", *kernel_build.NVCC_FLAGS,
                    "-o", str(lib_path), str(src)], check=True, timeout=300, capture_output=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 4 * n_sm
    out = (ctypes.c_int * (3 * 7 * blocks))()
    rc = ctypes.CDLL(str(lib_path)).probe_run(out, blocks, ctypes.c_longlong(PROBE_SPIN_CYCLES))
    assert rc == 0, rc
    per_sm = collections.defaultdict(list)
    for w in range(7 * blocks):
        per_sm[out[3 * w]].append(out[3 * w + 1])
    splits = collections.Counter(
        tuple(sorted(collections.Counter(slot % 4 for slot in slots).values(), reverse=True))
        for slots in per_sm.values())
    log(f"[24 width] probe: {blocks} blocks of 224 threads over {len(per_sm)} SMs, warps a scheduler (slot mod 4) "
        f"on each SM -> SMs: {dict(splits)} ({time.perf_counter() - t0:.2f} s)")
    return {"code": code, "ms": {str(b): {str(k): v for k, v in t.items()} for b, t in ms.items()},
            "equal_bits": {str(b): v for b, v in equal.items()},
            "scheduler_splits": {"/".join(map(str, k)): v for k, v in splits.items()}}


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
    from hallthrusterpem_tpu_torch import cuda_graph, kernel_build
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
    kernel_build.build_all()
    _kernels.load_libraries()
    for name, info in kernel_build.build_info.items():
        log(f"[2 build] {name} -> {info['path']} in {info['seconds']:.2f} s (cached={info['cached']})")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                log("    " + line.strip())
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=args.duration, device=dev)
    blocks_per_sm = _kernels.kstep_blocks_per_sm(pem.cfg)
    kname = f"kstep<{pem.cfg.ncharge},{pem.cfg.neutral_groups}>"
    sass = kernel_sass(_kernels.build_info["kstep"]["path"],
                       kstep_mangled(pem.cfg.ncharge, pem.cfg.neutral_groups, fs.lanes_for(pem.cfg)))
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

    # ---- 10. the one-step driver, its CUDA graphs and its eager route, vs the K-step driver: B = 1024, 914 steps
    t0 = time.perf_counter()
    small = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=2e-6, device=dev)
    params, _ = _coupled_pre(default_coupled_inputs(batch, torch.Generator().manual_seed(10),
                                                    spread=0.08, device=dev), small.cfg)
    n_small = small.cfg.num_steps
    real_capture, captures = cuda_graph.capture, []

    def timed_capture(*a, **k):
        t = time.perf_counter()
        g = real_capture(*a, **k)
        captures.append(time.perf_counter() - t)
        return g

    one_step = {}
    cuda_graph.capture = timed_capture
    try:
        # graphed then eager, twice: the second of each is timed (the first warms it)
        for label, graphs in (("graphed", True), ("eager", False)) * 2:
            captures.clear()
            torch.cuda.synchronize()
            _kernels.reset_counts()
            t1 = time.perf_counter()
            got = simulate_batch_step(params, small.base_B, small.cfg, graphs=graphs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            one_step[label] = {"out": got, "wall_s": wall, "launches": dict(_kernels.launch_counts),
                               "captures": len(captures), "capture_s": sum(captures)}
    finally:
        cuda_graph.capture = real_capture
    ref = fs.simulate_batch_multi(params, small.base_B, small.cfg)
    torch.cuda.synchronize()
    graphed, eager = one_step["graphed"], one_step["eager"]
    step_launches = graphed["launches"]
    for run_ in (graphed, eager):
        assert run_["launches"]["step"] == n_small and run_["launches"]["kstep"] == 0, run_["launches"]
    differ = [k for k in eager["out"] if not same_bits(graphed["out"][k], eager["out"][k])]
    got = graphed["out"]
    assert torch.equal(torch.isfinite(got["thrust"]), torch.isfinite(ref["thrust"]))
    ok = torch.isfinite(ref["thrust"])
    qoi_err = max(float(((got[k] - ref[k]).abs() / ref[k].abs())[ok].max())
                  for k in ("thrust", "discharge_current", "ion_current"))
    for run_ in (graphed, eager):
        run_["us_per_step"] = run_["wall_s"] / n_small * 1e6
    graphed["replay_us_per_step"] = (graphed["wall_s"] - graphed["capture_s"]) / n_small * 1e6
    # the card's busy time a step, from a torch.profiler trace of one graphed run
    busy_ms, traced_ms, n_events = device_busy(lambda: simulate_batch_step(params, small.base_B, small.cfg))
    graphed.update(card_busy_us_per_step=busy_ms / n_small * 1e3, card_events_per_step=n_events / n_small)
    log(f"[10 one-step driver] B={batch}, {n_small} steps, {step_launches['step']} step launches graphed and "
        f"{eager['launches']['step']} eager: graphed {graphed['wall_s'] * 1e3:.2f} ms a run "
        f"({graphed['us_per_step']:.2f} us a step; {graphed['captures']} captures {graphed['capture_s'] * 1e3:.2f} ms, "
        f"without them {graphed['replay_us_per_step']:.2f} us a step; the card busy "
        f"{graphed['card_busy_us_per_step']:.2f} us a step over {graphed['card_events_per_step']:.1f} events a step "
        f"in a traced run), eager {eager['wall_s'] * 1e3:.2f} ms a run "
        f"({eager['us_per_step']:.2f} us a step); outputs that differ from the eager route in any bit: "
        f"{differ or 'none'}; T/I_d/I_B0 vs the K-step driver max relative error {qoi_err:.3e} (tolerance "
        f"{QOI_RTOL:g}), finite {int(ok.sum())}/{batch} ({time.perf_counter() - t0:.2f} s)")
    assert not differ, differ
    assert qoi_err < QOI_RTOL and int(ok.sum()) > 0
    one_step_rec = {k: {f: v for f, v in r.items() if f != "out"} for k, r in one_step.items()}
    del got, ref, one_step, graphed, eager

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
    # ---- 19. the physics studies
    studies = study_phase(kstep_ms / K * 1e3)
    low_fidelity_kernels[0]["launches_diagnose_breathing"] = studies["launches"]["diagnose_breathing"]
    # ---- 20. parity_tpu (kstep against the lax solver's graphs) and mlp_sweep
    parity_sweep = parity_sweep_phase()
    # ---- 21. the port's bench.py as its user runs it
    bench = bench_phase(kstep_ms)
    # ---- 22. the plume's kernel
    plume_rec = plume_phase()
    # ---- 23. the H9-class system
    h9 = h9_phase()
    # ---- 24. the K-step kernel's lane width
    widths = width_phase()

    kernels = [{
        "name": "kstep", "instantiation": kname, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches["kstep"], "launches_wrapper_path": wrapper_launches["kstep"],
        "launches_uq_predictive": uq["predictive"]["kstep_launches"],
        "launches_two_shards": parallel["two_shards"]["kstep_launches"],
        "launches_gen_data": workflow["gen_data"]["kstep_launches"],
        "launches_fit_surr": workflow["fit_surr"]["kstep_launches"],
        **{f"launches_{k}": v for k, v in studies["launches"].items() if not k.startswith("diagnose_breathing")},
        **{f"launches_{k}": v for k, v in parity_sweep["launches"].items()},
        "launches_bench": bench["kstep_launches"][0],
        "max_abs_err": max_abs, "max_scaled_err": max_err,
        "max_scaled_err_trace": variant_err["trace"], "max_scaled_err_two_group": variant_err["two_group"],
        "scaled_err_tolerance": STATE_RTOL, "ms": kstep_ms, "plain_ms": kstep_plain_ms,
        "bound_ms": kstep_bound_3[0], "bound_by": kstep_bound_3[1], "library_ms": None,
        "blocks_per_sm": blocks_per_sm, "barriers_per_step": barriers, "sass_instructions": len(sass),
        "sass_instructions_per_step": step_insns, "sm_clock_mhz": sm_mhz, "issue_us_per_step": issue_us,
    }, *low_fidelity_kernels, {
        "name": "step", "route": "cuda", "source": STEP_SOURCE, "replaces": STEP_REPLACES,
        "launches": step_launches["step"], "launches_graphed": step_launches["step"],
        "launches_eager": one_step_rec["eager"]["launches"]["step"],
        "us_per_step_graphed": one_step_rec["graphed"]["us_per_step"],
        "us_per_step_graphed_replays": one_step_rec["graphed"]["replay_us_per_step"],
        "card_busy_us_per_step_graphed": one_step_rec["graphed"]["card_busy_us_per_step"],
        "us_per_step_eager": one_step_rec["eager"]["us_per_step"],
        "max_abs_err": step_abs, "max_scaled_err": step_err,
        "scaled_err_tolerance": STATE_RTOL, "ms": step_ms, "host_paced_ms": step_paced_ms,
        "plain_ms": step_plain_ms,
        "bound_ms": max(s_ops_ms, s_bytes_ms),
        "bound_by": "operations" if s_ops_ms >= s_bytes_ms else "bytes",
        "library_ms": None,
    }, plume_rec]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"lax": lax}), flush=True)
    print(json.dumps({"surrogate": surrogate}), flush=True)
    print(json.dumps({"uq": uq}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"workflow": workflow}), flush=True)
    print(json.dumps({"studies": studies}), flush=True)
    print(json.dumps({"parity_sweep": parity_sweep}), flush=True)
    print(json.dumps({"bench": bench}), flush=True)
    print(json.dumps({"h9": h9}), flush=True)
    print(json.dumps({"widths": widths}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
