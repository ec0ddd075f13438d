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
   barriers and instructions of one step and the instruction count by opcode,
   with the min/max opcodes (``FMNMX``, ``FSETP``, ``FSEL``) of one step of
   ``kstep<3,1>`` and of ``kstep<1,1>`` (fidelity (0,0));
4. main path: ``CoupledPEM(model_fidelity=(2,2), duration=2e-5)`` (9,138 steps)
   at B = 1024, one run with the launch count checked: phase 17's reference;
   ``python -m hallthrusterpem_tpu_torch.bench`` as a child process, its line,
   finite rows and launches checked;
6. the kernel's time per launch at B = 1024, its plain version's and its bound
   (counted as ``pembench/work.py`` counts a call: one lane per cell, its
   ``PEAKS``), beside its block barriers per step; the SM clock under load, and
   the time a step would take at that clock if every scheduler issued every
   cycle, beside ``kstep<1,1>``'s static instructions a warp-step; one launch
   against 50 plain steps at B = 1024 on the main path's
   config, with the trace lanes and with two neutral groups;
9. the wrapper path: ``hallthruster_jl`` on the pem_v0 SPT-100 Thruster
   component (of ``configs/pem_v0_SPT-100.json``) at fidelity (2,2), B = 1024,
   ``num_save`` 1000, cut to ``WRAPPER_DURATION`` (5e-4 s, the bench length),
   one call with its launches checked; the kernel's time per launch on this
   config, with the trace lanes and without; (b) ``System.predict(use_model=
   "best")`` on that JSON (B = ``SYSTEM_BATCH``) equal to a direct
   ``hallthruster_jl`` call; (c) the H9-class system (``H9_CONFIG``) at one call
   of ``H9_MIX``: its kernel flags, launches and counters, its first launch
   against the plain version;
10. the one-step driver at B = 1024, 914 steps, through its CUDA graphs and
    through its eager route (each launching the step kernel 914 times; timed,
    the captures apart), equal bit for bit, against the K-step driver;
11. the one-step kernel against its plain version (one step, B = 1024), its
    time per launch, its plain version's and its bound;
12. the lax solver (fidelity (2,2), B = 8, 200 steps) on the card through its
    replayed CUDA graphs (capture included) and through its eager route, timed,
    in float32 and in float64;
13. the full-width lax path: ``CoupledPEM(model_fidelity=(4,2))`` (300 cells + 2
    ghosts, 3 charge states) at B = 1024 for 2,000 steps through the CUDA
    graphs in one segment and in 500-step chunks, and through the eager route,
    all three equal bit for bit, timed; then float64 at fidelity (2,2),
    B = 1024, 500 steps, timed; the capture's seconds and ``LAX_REPLAYS``
    replays of one graph timed, and the card's busy time a step from
    ``torch.profiler`` traces of one replay and of 20 eager steps;
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
17. the multi-device path on phase 4's inputs (B = 1024) and outputs, each
    equal bit for bit with its launches counted: (a) ``BatchExecutor(
    make_mesh())``; (b) ``simulate_batch_sharded`` on two shards of the card; (c) two
    processes on the card (``parallel.distributed.initialize``, gloo on a free
    localhost port), each ``process_local_batch`` of half the rows, then
    ``gather_to_host``, equal to phase 4 bit for bit; (d) the host's µs per
    ``kstep`` launch with 1 and 2 threads enqueuing (``PARALLEL_HOST_LAUNCHES``
    each);
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
22. the plume's kernel at the rows a call of each benchmark cell holds
    (``PLUME_ROWS``), float32 with the thrust ``T`` and every eighth row masked
    (NaN ``I_B0`` and ``T``): against its plain version, its time on the card a
    launch (back to back), its host time a call, its bound, and the plain
    version's wall a call and operators a call.

The numbers skip the phases whose checks the ``gpu`` tests
(``tests/test_torch_gpu.py``) or the benchmark's cells (``pembench/``) make.
It prints a ``{"lax": {...}}`` line (phases 12-13), a ``{"surrogate": {...}}``
line (phase 15), a ``{"uq": {...}}`` line (phase 16), a ``{"parallel": {...}}``
line (phase 17), a ``{"workflow": {...}}`` line (phase 18), a ``{"studies": {...}}``
line (phase 19), a ``{"parity_sweep": {...}}`` line (phase 20), ``{"bench": {...}}``
(phase 4) and ``{"systems": {...}}`` (phase 9) lines, a ``{"kernels": [...]}``
line (``kstep<3,1>``, ``kstep<1,1>``, ``kstep<2,1>``, ``step``, ``plume``), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without a CUDA device it exits non-zero before
printing any result.
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
# the lax solver (phases 12-13): batch and steps of the small runs; batch and
# steps of the full-width fidelity (4,2) run, its chunk, and the steps of its
# segment traced by torch.profiler; steps of the float64 run at fidelity (2,2)
LAX_SMALL_BATCH = 8
LAX_SMALL_STEPS = 200
LAX_BATCH = 1024
LAX_WIDE_STEPS = 2000
LAX_CHUNK = 500
LAX_TRACE_STEPS = 20
LAX_REPLAYS = 4  # phase 13: replays of one captured graph, timed
LAX_F64_STEPS = 500
SYSTEM_BATCH = 256  # phase 9b: System.predict on pem_v0_SPT-100.json
# phase 9c: the H9-class system and one call of its cell's traffic
H9_CONFIG = "pembench/configs/h9_pem_v0_a22.json"
H9_MIX = "h9_pressure_sweep"
H9_SEED = 23
BENCH_TIMEOUT = 300  # phase 4: the seconds the bench's child process may take
BENCH_FINITE = 1014  # phase 4: the finite rows of 1,024 the bench must report
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
# phase 22: the plume's kernel
PLUME_SOURCE = "hallthrusterpem_tpu_torch/models/csrc/plume.cu"
PLUME_ROWS = (23, 1024, 1472)  # a call of a22_mcmc_eval, a00_labelling, a22_predictive
PLUME_TOL = 1e-6
PLUME_DIV_TOL_F32 = 5e-6  # the sum order alone moves arccos by up to 2.1e-6 (tests/test_torch_plume_emulated.py)
PLUME_REPS = 200

def log(msg: str) -> None:
    print(msg, flush=True)


def scaled_err(a, b) -> float:
    """max |a - b| / max |b|: the error in units of the array's own scale."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def carry_errs(fs, got, ref, trace: bool = False) -> tuple:
    """(max scaled error, max absolute error, arrays compared) of one K-step
    carry ``(state, prof, sacc)`` against another: each state and profile row,
    and the accumulator slots up to the circuit current (with ``trace``, the
    trace slots of one launch too)."""
    (ks, kp, ka), (ps, pp, pa) = got, ref
    slots = list(range(fs.A_ICIR + 1)) + (list(range(fs.A_TRACE0, fs.A_TRACE0 + fs.INNER_STEPS)) if trace else [])
    pairs = [(ks[j], ps[j]) for j in range(ks.shape[0])] + [(kp[j], pp[j]) for j in range(kp.shape[0])]
    pairs += [(ka[:, j], pa[:, j]) for j in slots]
    return (max(scaled_err(k, p) for k, p in pairs), max(float((k - p).abs().max()) for k, p in pairs),
            len(pairs))


def kstep_vs_plain(fs, base_B, cfg, seed: int) -> tuple:
    """One K-step launch against ``fs.INNER_STEPS`` plain steps from the same
    carry at B = 1024, accumulating from step 0: :func:`carry_errs` of the two,
    after checking that the kernel's carry is finite."""
    import torch

    from hallthrusterpem_tpu_torch.pem import _coupled_pre, default_coupled_inputs

    cfg = dataclasses.replace(cfg, average_start_time=0.0)
    x = default_coupled_inputs(1024, torch.Generator().manual_seed(seed), spread=0.08, device="cuda")
    consts, *ref = fs.init_carry(_coupled_pre(x, cfg)[0], base_B, cfg)
    got = [t.clone() for t in ref]
    fs.kstep(*got, consts, 0, fs.INNER_STEPS, cfg, fs.Physics(cfg))
    fs.kstep_plain(*ref, consts, 0, fs.INNER_STEPS, cfg, fs.Physics(cfg))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got), "kernel carry not finite"
    return carry_errs(fs, got, ref, trace=bool(cfg.num_save))


def bound(ops: int, n_bytes: int) -> dict:
    """The least time on this card of ``ops`` float32 operations and
    ``n_bytes`` bytes: the larger of the two over its published rates
    (``PEAKS`` of ``pembench/work.py``)."""
    import torch

    from pembench.work import PEAKS

    flops, bandwidth = PEAKS[torch.cuda.get_device_name(0)]
    ops_ms, bytes_ms = ops / flops * 1e3, n_bytes / bandwidth * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": ops, "bytes": n_bytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def per_cell(consts: dict, tensors, nc: int) -> tuple:
    """Copies of ``consts`` and of the lane-layout ``tensors`` cut to lanes
    0..nc-1: one lane per cell and ghost cell, no padding lanes, as
    ``pembench/work.py`` counts a row's work."""
    cut = lambda x: x[..., :nc].clone()
    return dict(consts, nu_anom=cut(consts["nu_anom"]), omega_ce=cut(consts["omega_ce"])), [cut(t) for t in tensors]


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
    warp, and those instructions by opcode, read from its SASS. A loop is a
    backward branch; the step loop is the outermost loop that holds a barrier,
    and the one loop it may hold is the PCR's (``#pragma unroll 1`` in
    physics.cuh), which runs ``n_levels`` times a step. Instructions are static:
    both sides of a branch count, and the subroutines it calls (the slow paths
    of IEEE division) do not."""
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
    ops = collections.Counter(op.split(".")[0] for _, op, _ in body)
    for _ in range(n_levels - 1):
        ops.update(op.split(".")[0] for _, op, _ in pcr)
    return bars(body) + (n_levels - 1) * bars(pcr), len(body) + (n_levels - 1) * len(pcr), ops


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


def kstep_bound(fs, kernels, carry, cfg) -> dict:
    """The least time of one K = 50 launch from ``carry`` ``(consts, state,
    prof, sacc)``, on a copy with one lane per cell (:func:`per_cell`): the
    larger of its operations (counted on the plain version: one step's and the
    set-up's, from 1 and 2 steps) over the card's float32 rate and its bytes
    over the memory rate. ``bytes``: state and profile sums read and written;
    of each sample's 128 accumulator slots the ones up to the circuit current
    read and written (no trace lanes), of its 128 scalar slots the ones before
    it read; the lane constants and the rate coefficients read."""
    from pembench.work import count_ops

    consts, (state, prof) = per_cell(carry[0], carry[1:3], cfg.nc)
    sacc = carry[3].clone()
    physics = fs.Physics(cfg, cfg.nc)
    K, batch = fs.INNER_STEPS, sacc.shape[0]
    ops1 = count_ops(lambda: fs.kstep_plain(state, prof, sacc, consts, 0, 1, cfg, physics))
    ops2 = count_ops(lambda: fs.kstep_plain(state, prof, sacc, consts, 0, 2, cfg, physics))
    ops = (ops1 - (ops2 - ops1)) + K * (ops2 - ops1)
    n_bytes = 4 * (2 * (state.numel() + prof.numel()) + 2 * batch * (fs.A_ICIR + 1)
                   + consts["nu_anom"].numel() + consts["omega_ce"].numel()
                   + batch * fs.P_ICIR + kernels.rate_coefficients(cfg).size)
    return dict(bound(ops, n_bytes), ops_per_step=ops2 - ops1)


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
    """Phases 12 and 13: the lax solver's two routes on the card, timed, then
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
    # ---- 12. the lax solver's graphs and eager route: fidelity (2,2), B = 8
    t0 = time.perf_counter()
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=2e-5, device=dev)
    inp = default_coupled_inputs(LAX_SMALL_BATCH, torch.Generator().manual_seed(12), spread=0.08, device=dev)
    for dtype in ("float32", "float64"):
        cfg = dataclasses.replace(pem.cfg, dtype=dtype, average_start_time=0.0,
                                  duration=LAX_SMALL_STEPS * pem.cfg.dt)
        params, _ = _coupled_pre(inp, cfg)
        carry = solver._init_batch(params, pem.base_B, cfg)
        walls = []
        for segment in (solver._segment_batch, solver._segment_batch_eager):
            sync()
            t1 = time.perf_counter()
            segment(params, pem.base_B, carry, cfg, LAX_SMALL_STEPS)
            sync()
            walls.append(time.perf_counter() - t1)
        record[f"graph_s_{dtype}"], record[f"eager_s_{dtype}"] = walls
        log(f"[12 lax] {dtype}, {cfg.num_cells} cells, {cfg.ncharge} charge states, B={LAX_SMALL_BATCH}, "
            f"{LAX_SMALL_STEPS} steps: CUDA graphs {walls[0]:.3f} s with their capture, eager {walls[1]:.3f} s")
    log(f"[12 lax] done ({time.perf_counter() - t0:.2f} s)")

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
    b = bound(ops, n_bytes)
    rec["train"] = {"hidden": list(SURR_HIDDEN), "ensemble": K, "steps": SURR_STEPS, "batch": B,
                    "n_in": surr.n_in, "n_out": surr.n_out, "params": n_par, "wall_s": fit_s,
                    "ms_per_step": step_ms, "ops_per_step": ops, "bytes_per_step": n_bytes,
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                    "val_rmse": info["val_rmse"], "val_fail_acc": info["val_fail_acc"], "tf32": False}
    log(f"[15b train] MLPSurrogate {SURR_HIDDEN} x {K} members, {surr.n_in} inputs -> {surr.n_out} outputs + "
        f"fail logit, {n_par} parameters: fit of {SURR_STEPS} steps at batch {B} in {fit_s:.3f} s; "
        f"{step_ms:.3f} ms/step on the card (TF32 off), {ops:.3e} ops and {n_bytes:.3e} bytes a step -> bound "
        f"{b['bound_ms']:.3f} ms (ops, float32 {b['ops_ms']:.3f}, bytes {b['bytes_ms']:.4f}), "
        f"{step_ms / b['bound_ms']:.2f}x; val_rmse {info['val_rmse']:.4f}, "
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
    ref_np = {k: v.cpu().numpy() for k, v in ref.items()}

    def unequal(out) -> list:
        """The outputs that differ from phase 4's in any bit (NaN rows alike)."""
        got = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in out.items()}
        assert set(got) == set(ref_np), (sorted(got), sorted(ref_np))
        return [k for k in ref_np if got[k].dtype != ref_np[k].dtype
                or not np.array_equal(got[k], ref_np[k], equal_nan=True)]

    rec: dict = {"batch": batch, "duration_s": pem.cfg.duration}

    # ---- (a) every card of the machine; (b) two shards on one card, then the plume
    mesh = make_mesh()
    _kernels.reset_counts()
    out = BatchExecutor(mesh).run(pem, inputs)
    for d in set(mesh.devices):
        torch.cuda.synchronize(d)
    launches, diff = _kernels.launch_counts["kstep"], unequal(out)
    log(f"[17a every card] BatchExecutor(make_mesh()) over {mesh.n_devices} card(s), B={batch}: kstep launches "
        f"{launches}; outputs that differ from phase 4 in any bit: {diff or 'none'}")
    assert not diff and launches == mesh.n_devices * n_launch, (diff, launches, mesh.n_devices, n_launch)
    rec["every_card"] = {"cards": mesh.n_devices, "kstep_launches": launches, "bit_equal": True}
    params, v_cc = _coupled_pre(inputs, pem.cfg)
    _kernels.reset_counts()
    sol = simulate_batch_sharded(params, pem.base_B, pem.cfg, Mesh([torch.device("cuda", 0)] * 2))
    torch.cuda.synchronize()
    launches, diff = _kernels.launch_counts["kstep"], unequal(_coupled_post(inputs, v_cc, sol, pem.sweep_radius,
                                                                            pem.cfg))
    log(f"[17b two shards] simulate_batch_sharded on Mesh([cuda:0, cuda:0]), 2 x {batch // 2} rows: kstep "
        f"launches {launches} (phase 4: {n_launch} a run); outputs that differ from phase 4 in any bit: "
        f"{diff or 'none'}")
    assert not diff and launches == 2 * n_launch, (diff, launches, n_launch)
    rec["two_shards"] = {"kstep_launches": launches, "bit_equal": True}
    del out, sol, params, v_cc

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
    params, _ = _coupled_pre(inputs, pem.cfg)
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
        least = kstep_bound(fs, _kernels, carry, cfg)
        log(f"[18a {name}] fidelity {fid} ({cfg.num_cells} cells, {fs.lanes_for(cfg)} lanes), B={WORKFLOW_BATCH}: "
            f"1 launch (K={K}) vs {K} plain steps, max scaled error {err:.3e} (tolerance {STATE_RTOL:g}), max "
            f"absolute error {err_abs:.3e} over {n_arrays} arrays; {ms:.3f} ms/launch, plain {plain_ms:.1f} ms, "
            f"bound {least['bound_ms']:.4f} ms by {least['bound_by']} ({ms / least['bound_ms']:.2f}x; "
            f"{least['ops_per_step'] / WORKFLOW_BATCH:.0f} ops a row-step)")
        assert err < STATE_RTOL, (name, err)
        entries[fid] = {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                        "launches": launches[fid], "launches_install_solver": launches[fid],
                        "max_abs_err": err_abs, "max_scaled_err": err, "scaled_err_tolerance": STATE_RTOL,
                        "batch": WORKFLOW_BATCH, "ms": ms, "plain_ms": plain_ms, "bound_ms": least["bound_ms"],
                        "bound_by": least["bound_by"], "library_ms": None}
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


def bench_child() -> dict:
    """Phase 4's ``python -m hallthrusterpem_tpu_torch.bench`` with its defaults
    as a child process: its line, finite rows and launches a timed run."""
    import os

    import torch

    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.pem import CoupledPEM

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # leave the card's memory to the child
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "hallthrusterpem_tpu_torch.bench"], capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT, env=env, cwd=Path(__file__).resolve().parent)
    assert proc.returncode == 0, f"the bench exited with {proc.returncode}: {proc.stderr[-2000:]}"
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    finite = re.search(r"(\d+)/(\d+) finite", proc.stderr)
    runs = re.search(r"(\d+) steps, kstep launches per timed run \[(\d+), (\d+)\]", proc.stderr)
    assert finite and runs, proc.stderr[-2000:]
    n_ok, batch, steps = int(finite.group(1)), int(finite.group(2)), int(runs.group(1))
    launches = [int(runs.group(2)), int(runs.group(3))]
    expect = math.ceil(CoupledPEM(thruster="SPT-100", model_fidelity=(2, 2), duration=5e-4,  # the bench's default
                                  device="cuda").cfg.num_steps / fs.INNER_STEPS)
    log(f"[4 bench] {json.dumps(line)}; {n_ok}/{batch} rows finite, {steps} steps, kstep launches per timed run "
        f"{launches} (expected {expect}) ({time.perf_counter() - t0:.2f} s)")
    assert list(line) == ["metric", "value", "unit", "vs_baseline"], line
    assert line["metric"] == "coupled_pem_sim_ms_per_sec_per_chip" and math.isfinite(line["value"]), line
    assert batch == 1024 and n_ok >= BENCH_FINITE, (n_ok, batch)
    assert launches == [expect, expect], (launches, expect)
    return {"line": line, "finite_rows": n_ok, "steps": steps, "kstep_launches": launches[0]}


def system_paths() -> dict:
    """Phase 9's System paths, one untimed call each with its launches counted:
    ``System.predict(use_model="best")`` on the pem_v0 SPT-100 JSON
    configuration, the Thruster cut to ``WRAPPER_DURATION``, against a direct
    ``hallthruster_jl`` call on the same inputs; and the H9-class system at one
    call of its cell's traffic, its first launch against the plain version."""
    import torch

    import hallthrusterpem_tpu_torch.models.thruster as thruster
    from hallthrusterpem_tpu_torch import tracing
    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from pembench.traffic import Traffic, load_mix

    dev, batch, duration = torch.device("cuda"), SYSTEM_BATCH, WRAPPER_DURATION
    t0 = time.perf_counter()
    system = load_system("pem_v0_SPT-100.json", device=dev)
    comp = system["Thruster"]
    comp.model_kwargs["simulation"] = dict(comp.model_kwargs["simulation"], duration=duration)
    comp.model_kwargs["postprocess"] = dict(comp.model_kwargs["postprocess"], average_start_time=0.5 * duration)
    samples = system.sample_inputs(batch, generator=torch.Generator().manual_seed(14))
    _kernels.reset_counts()
    out = system.predict(samples, use_model="best")
    torch.cuda.synchronize()
    launches = _kernels.launch_counts["kstep"]
    assert launches > 0 and out["j_ion"].shape == (batch, 91), _kernels.launch_counts
    direct = thruster.hallthruster_jl({n: out[n] for n in comp.input_names()},
                                      model_fidelity=comp.model_fidelity, device=dev, **comp.model_kwargs)
    for k in comp.output_names():
        assert torch.equal(torch.isnan(out[k]), torch.isnan(direct[k])) and torch.equal(
            torch.nan_to_num(out[k]), torch.nan_to_num(direct[k])), f"System output {k} differs"
    log(f"[9b System] pem_v0_SPT-100.json, Thruster duration {duration:g} s, B={batch}: Cathode -> Thruster -> "
        f"Plume, kstep launches {launches}, finite {int(torch.isfinite(out['T']).sum())}/{batch}; Thruster outputs "
        f"equal a direct hallthruster_jl call ({time.perf_counter() - t0:.2f} s)")
    rec = {"spt100": {"batch": batch, "kstep_launches": launches}}

    t0 = time.perf_counter()
    path = Path(__file__).resolve().parent / H9_CONFIG
    doc = json.loads(path.read_text())
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
        out = load_system(path, device=dev).predict(rows, use_model=doc["use_model"])
        torch.cuda.synchronize()
    finally:
        fs.kstep = launch
    change = {k: tracing.counts[k] - before[k] for k in tracing.counts}
    cfg, flags, (err, abs_err, n_arrays) = first["cfg"], first["flags"], first["errs"]
    launches, expected, n = _kernels.launch_counts["kstep"], math.ceil(cfg.num_steps / first["K"]), len(rows["P_b"])
    branch = {"ion_wall": flags.ion_wall, "solve_plume": flags.solve_plume, "div_corr": flags.div_corr,
              "trace": flags.trace, "circuit_max": first["circuit"]}
    log(f"[9c H9] {H9_CONFIG}, {n} rows ({H9_MIX}, seed {H9_SEED}): kstep<{cfg.ncharge},{cfg.neutral_groups}>, "
        f"{cfg.num_cells} cells, {cfg.num_steps} steps, {launches} launches (expected {expected}); flags {branch}; "
        f"first launch vs {first['K']} plain steps: max scaled error {err:.3e} (tolerance {STATE_RTOL:g}), max "
        f"absolute {abs_err:.3e} over {n_arrays} arrays; finite {int(torch.isfinite(out['T']).sum())}/{n}; "
        f"counters {change} ({time.perf_counter() - t0:.2f} s)")
    assert (cfg.ncharge, cfg.neutral_groups, cfg.num_cells, cfg.anom_model, cfg.pressure_shift) == (
        3, 1, 200, "GaussianBohm", "SimpleLogisticShift"), cfg
    assert branch == {"ion_wall": 0, "solve_plume": 0, "div_corr": 0, "trace": 1, "circuit_max": 0.0}, branch
    assert launches == expected and err < STATE_RTOL, (launches, expected, err)
    assert change["gaussian_bohm_rows"] == change["plume_kernel_rows"] == change["rows_attempted"] == n, change
    rec["h9"] = {"rows": n, "kstep_launches": launches, "flags": branch, "first_launch_max_scaled_err": err,
                 "first_launch_max_abs_err": abs_err, "counters": change}
    return rec


def plume_inputs(rows: int, seed: int) -> dict:
    """The plume's System inputs for ``rows`` rows on the card, float32: drawn
    from the pem_v0 SPT-100 distributions, with I_B0 and T as the Thruster gives
    them and every eighth row NaN in both (a row the Thruster masked)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = {"P_b": 10 ** rng.uniform(-8, -4, rows), "c0": rng.uniform(0, 1, rows),
         "c1": rng.uniform(0.1, 1, rows), "c2": rng.uniform(-15, 15, rows),
         "c3": rng.uniform(0.2, np.pi / 2, rows), "c4": 10 ** rng.uniform(18, 22, rows),
         "c5": 10 ** rng.uniform(14, 18, rows), "sigma_cex": rng.uniform(51e-20, 58e-20, rows),
         "I_B0": rng.uniform(2, 5, rows), "T": rng.uniform(0.04, 0.1, rows)}
    x["I_B0"][::8] = x["T"][::8] = np.nan
    return {k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in x.items()}


def plume_phase() -> dict:
    """Phase 22: the plume's kernel against its plain version and timed, at
    each of ``PLUME_ROWS``; returns its entry of the kernels line."""
    import torch

    from hallthrusterpem_tpu_torch.models import plume
    from pembench.work import count_ops

    t0 = time.perf_counter()
    rec = {"name": "plume", "route": "cuda", "source": PLUME_SOURCE,
           "replaces": "none: the plume's eager version made ~1,300 launches a call",
           "scaled_err_tolerance": PLUME_TOL, "div_angle_tolerance": PLUME_DIV_TOL_F32, "library_ms": None,
           "rows": {}}
    for rows in PLUME_ROWS:
        x = plume_inputs(rows, seed=rows)
        got, ref = plume.current_density(x), plume.current_density_plain(x)  # the first: the grid on this card
        assert set(got) == set(ref) and "T_c" in ref, (sorted(got), sorted(ref))
        errs = {}
        for k, r in ref.items():
            fin = torch.isfinite(r)
            assert got[k].dtype == r.dtype and torch.equal(torch.isfinite(got[k]), fin), (rows, k, got[k].dtype)
            errs[k] = scaled_err(got[k][fin], r[fin])
            assert errs[k] < (PLUME_DIV_TOL_F32 if k == "div_angle" else PLUME_TOL), (rows, k, errs[k])
        plume.reset_counts()
        ms = cuda_ms(lambda: plume.current_density(x), PLUME_REPS, lead=True)
        assert plume.launch_counts["plume"] == PLUME_REPS, plume.launch_counts
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
        n_bytes = 4 * (rows * (10 + 91 + 2) + 4 * 91)  # inputs, j_ion, div_angle and T_c, the grid
        entry = dict(bound(count_ops(lambda: plume.current_density_plain(x)), n_bytes), max_scaled_err=errs,
                     ms=ms, host_us=host_us,
                     plain_ms=plain_ms, plain_operators=count_dispatches(lambda: plume.current_density_plain(x)))
        log(f"[22 plume] B={rows}: {ms * 1e3:.2f} us a launch on the card (back to back), "
            f"{host_us:.1f} us of host time a call, bound {entry['bound_ms'] * 1e3:.3f} us "
            f"({entry['bound_by']}: {entry['ops']:.3e} ops, {n_bytes:.3e} bytes); plain {plain_ms:.2f} ms "
            f"a call, {entry['plain_operators']} operators; against it max scaled error "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        rec["rows"][rows] = entry
    rec.update({k: rec["rows"][PLUME_ROWS[-1]][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, launches=1)
    log(f"[22 plume] done ({time.perf_counter() - t0:.2f} s)")
    return rec


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
    from hallthrusterpem_tpu_torch.core.json_loader import load_system
    from hallthrusterpem_tpu_torch.models.cathode import cathode_coupling
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.models.thruster.one_step import simulate_batch_step
    from hallthrusterpem_tpu_torch.pem import CoupledPEM, _coupled_pre, default_coupled_inputs
    from pembench.work import PEAKS, count_ops

    # ---- 1. device
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0].strip()
    assert kind in PEAKS, f"{kind}: no published rates in pembench/work.py's PEAKS, so no bound"
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
    barriers, step_insns, step_ops = step_loop_counts(sass, n_levels)
    opcodes = collections.Counter(op.split(".")[0] for _, op, _ in sass)
    minmax = lambda ops: ", ".join(f"{k} {ops[k]}" for k in ("FMNMX", "FSETP", "FSEL"))
    log(f"[2 build] {kname} at {fs.lanes_for(pem.cfg)} threads: {blocks_per_sm} blocks per SM; "
        f"in its SASS, per step ({n_levels} PCR levels): {barriers} block barriers, {step_insns} "
        f"instructions a warp issues (static, both sides of each branch; {minmax(step_ops)}); "
        f"{len(sass)} instructions in all: " + ", ".join(f"{k} {n}" for k, n in opcodes.most_common(12))
        + f" ({time.perf_counter() - t0:.2f} s)")
    # kstep<1,1> at fidelity (0,0): the same counts of its step loop
    cfg00 = CoupledPEM(thruster="SPT-100", model_fidelity=(0, 0), duration=args.duration, device=dev).cfg
    sass00 = kernel_sass(_kernels.build_info["kstep"]["path"],
                         kstep_mangled(cfg00.ncharge, cfg00.neutral_groups, fs.lanes_for(cfg00)))
    levels00 = _kernels.kernel_params(cfg00).n_levels
    barriers00, step_insns00, step_ops00 = step_loop_counts(sass00, levels00)
    log(f"[2 build] kstep<{cfg00.ncharge},{cfg00.neutral_groups}> at {fs.lanes_for(cfg00)} threads, per step "
        f"({levels00} PCR levels): {barriers00} block barriers, {step_insns00} instructions a warp issues "
        f"({minmax(step_ops00)}); {len(sass00)} instructions in all")

    # ---- 4. main path: CoupledPEM at fidelity (2,2), B = 1024
    t0 = time.perf_counter()
    batch, K = 1024, fs.INNER_STEPS
    n_launch = math.ceil(pem.cfg.num_steps / K)
    main_inputs = default_coupled_inputs(batch, torch.Generator().manual_seed(1), spread=0.08, device=dev)
    _kernels.reset_counts()
    main_out = pem(main_inputs)  # phase 17 holds the multi-device path to these, bit for bit
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    n_ok = int(torch.isfinite(main_out["T"]).sum())
    log(f"[4 main path] {pem.cfg.num_steps} steps x B={batch}: finite {n_ok}/{batch}, "
        f"kstep launches {launches['kstep']} ({time.perf_counter() - t0:.2f} s)")
    assert launches["kstep"] == n_launch, (launches, n_launch)
    assert n_ok >= batch - 10, n_ok
    assert main_out["j_ion"].shape == (batch, 91) and main_out["u_ion"].shape == (batch, pem.cfg.nc)
    bench = bench_child()

    # ---- 6. the kernel's time, its plain version's and its bound, at B = 1024, K = 50
    t0 = time.perf_counter()
    params, _ = _coupled_pre(default_coupled_inputs(batch, torch.Generator().manual_seed(5),
                                                    spread=0.08, device=dev), pem.cfg)
    consts, state, prof, sacc = fs.init_carry(params, pem.base_B, pem.cfg)
    physics = fs.Physics(pem.cfg)
    launch = lambda block: block(state, prof, sacc, consts, 0, K, pem.cfg, physics)
    launch(fs.kstep)
    kstep_ms = cuda_ms(lambda: launch(fs.kstep), 20, lead=True)
    kstep_plain_ms = cuda_ms(lambda: launch(fs.kstep_plain), 1)
    kstep_least = kstep_bound(fs, _kernels, (consts, state, prof, sacc), pem.cfg)
    log(f"[6 timing] kstep B={batch} K={K}: {kstep_ms:.3f} ms/launch ({kstep_ms / K * 1e3:.2f} us/step, "
        f"{kstep_ms / kstep_least['bound_ms']:.2f}x the bound), plain {kstep_plain_ms:.1f} ms; "
        f"{kstep_least['ops_per_step'] / batch:.0f} ops a row-step ({pem.cfg.nc} lanes), {kstep_least['ops']:.3e} ops "
        f"and {kstep_least['bytes']:.3e} bytes per launch -> bound {kstep_least['bound_ms']:.4f} ms (ops "
        f"{kstep_least['ops_ms']:.4f}, bytes {kstep_least['bytes_ms']:.4f}); {barriers} block barriers per step, "
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
        + f" against {kstep_ms / K * 1e3:.2f} measured; kstep<{cfg00.ncharge},{cfg00.neutral_groups}> "
        f"{step_insns00} static instructions a warp-step")
    del params, consts, state, prof, sacc
    kstep_errs = {label: kstep_vs_plain(fs, pem.base_B, dataclasses.replace(pem.cfg, **variant), seed)
                  for label, variant, seed in (("plain", {}, 7), ("trace", {"num_save": 1000}, 8),
                                                ("two_group", {"neutral_groups": 2}, 8))}
    log(f"[6 parity] 1 launch (K={K}) vs {K} plain steps, B={batch}: " + "; ".join(
        f"{label} max scaled error {e:.3e}, max absolute {a:.3e} over {n} arrays"
        for label, (e, a, n) in kstep_errs.items()) + f" (tolerance {STATE_RTOL:g}) "
        f"({time.perf_counter() - t0:.2f} s)")
    assert all(e < STATE_RTOL for e, _, _ in kstep_errs.values()), kstep_errs

    # ---- 9. the wrapper path: hallthruster_jl, pem_v0 SPT-100 component, B = 1024; the System paths
    t0 = time.perf_counter()
    thruster_comp = load_system("pem_v0_SPT-100.json", device=dev)["Thruster"]
    comp, fidelity = thruster_comp.model_kwargs, thruster_comp.model_fidelity
    simulation = dict(comp["simulation"], duration=WRAPPER_DURATION)
    postprocess = dict(comp["postprocess"], average_start_time=0.5 * WRAPPER_DURATION)
    tree_kw = dict(thruster=comp["thruster"], config=comp["config"], simulation=simulation,
                   postprocess=postprocess, model_fidelity=fidelity)

    def thruster_inputs(seed):
        x = default_coupled_inputs(batch, torch.Generator().manual_seed(seed), spread=0.08, device=dev)
        v_cc = cathode_coupling({k: x[k] for k in ("P_b", "V_a", "T_e", "V_vac", "Pstar", "P_T")})["V_cc"]
        return dict({k: v for k, v in x.items() if k in thruster.PEM_TO_JULIA}, V_cc=v_cc)

    tree = thruster.format_input_tree(thruster_inputs(42), thruster.PEM_TO_JULIA, **tree_kw)
    wcfg, wparams, wbase_B = thruster._tree_to_solver_inputs(tree, dev)
    _kernels.reset_counts()
    out = thruster.hallthruster_jl(thruster_inputs(42), device=dev, **tree_kw)
    torch.cuda.synchronize()
    wrapper_launches, ok, trace = dict(_kernels.launch_counts), torch.isfinite(out["T"]), out["discharge_current_trace"]
    log(f"[9 wrapper path] hallthruster_jl, {wcfg.num_steps} steps x B={batch}: finite {int(ok.sum())}/{batch}, "
        f"kstep launches {wrapper_launches['kstep']}")
    assert wrapper_launches["kstep"] == math.ceil(wcfg.num_steps / K) and wrapper_launches["step"] == 0
    assert int(ok.sum()) >= batch - 10 and trace.shape == (batch, 1000) and bool(torch.isfinite(trace[ok]).all())
    assert out["u_ion"].shape == (batch, wcfg.nc) and out["model_cost"].shape == (batch,)
    del out, trace
    wrapper_ms = {}
    for label, c in (("trace", wcfg), ("no trace", dataclasses.replace(wcfg, num_save=0))):
        carry = fs.init_carry(wparams, wbase_B, c)
        launch_w = lambda: fs.kstep(carry[1], carry[2], carry[3], carry[0], 0, K, c)
        launch_w()
        wrapper_ms[label] = cuda_ms(launch_w, 20, lead=True)
    log(f"[9 wrapper path] fidelity {fidelity}, {wcfg.num_cells} cells, {wcfg.ncharge} charge states, adaptive "
        f"dt {wcfg.dt:.4e} s, num_save {wcfg.num_save}: kstep from the initial state, B={batch} K={K}: "
        f"{wrapper_ms['trace']:.3f} ms/launch with the trace lanes, {wrapper_ms['no trace']:.3f} without (main "
        f"path config: {kstep_ms:.3f}) ({time.perf_counter() - t0:.2f} s)")
    del carry, wparams
    systems = system_paths()

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
    assert not differ and torch.equal(torch.isfinite(got["thrust"]), torch.isfinite(ref["thrust"])), differ
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
        f"({eager['us_per_step']:.2f} us a step), equal bit for bit; T/I_d/I_B0 vs the K-step driver max relative "
        f"error {qoi_err:.3e} (tolerance {QOI_RTOL:g}), finite {int(ok.sum())}/{batch} ({time.perf_counter() - t0:.2f} s)")
    assert qoi_err < QOI_RTOL and int(ok.sum()) > 0
    one_step_rec = {k: {f: v for f, v in r.items() if f != "out"} for k, r in one_step.items()}
    del got, ref, one_step, graphed, eager, params

    # ---- 11. the one-step kernel's time, its plain version's and its bound, B = 1024
    t0 = time.perf_counter()
    params, _ = _coupled_pre(default_coupled_inputs(batch, torch.Generator().manual_seed(9),
                                                    spread=0.08, device=dev), pem.cfg)
    consts, state, prof, sacc = fs.init_carry(params, pem.base_B, pem.cfg)
    fs.kstep(state, prof, sacc, consts, 0, K, pem.cfg)  # leave the smooth initial state
    consts["scalars"][:, fs.P_ICIR] = sacc[:, fs.A_ICIR]
    extras = torch.zeros((5,) + tuple(state.shape[1:]), device=dev)
    ks, kx, ps, px = state.clone(), extras.clone(), state.clone(), extras.clone()
    fs.step(ks, kx, consts, pem.cfg)
    fs.step_plain(ps, px, consts, pem.cfg, physics)
    torch.cuda.synchronize()
    pairs = [(ks[j], ps[j]) for j in range(ks.shape[0])] + [(kx[j], px[j]) for j in range(5)]
    assert all(bool(torch.isfinite(k).all()) for k, _ in pairs), "step kernel output not finite"
    step_err = max(scaled_err(k, p) for k, p in pairs)
    step_abs = max(float((k - p).abs().max()) for k, p in pairs)
    log(f"[11 step parity] 1 step, B={batch}: max scaled error {step_err:.3e} (tolerance {STATE_RTOL:g}), "
        f"max absolute error {step_abs:.3e} over {len(pairs)} arrays")
    assert step_err < STATE_RTOL
    step_ms = cuda_ms(lambda: fs.step(state, extras, consts, pem.cfg), 50, lead=True)
    step_paced_ms = cuda_ms(lambda: fs.step(state, extras, consts, pem.cfg), 50)
    step_plain_ms = cuda_ms(lambda: fs.step_plain(state, extras, consts, pem.cfg, physics), 3)
    # counted with one lane per cell: state read and written, the 5 output
    # arrays written, the lane constants, of each sample's 128 scalar slots the
    # 9 it reads (P_DV .. P_ICIR), and the rate coefficients read
    cell_consts, (cell_state, cell_extras) = per_cell(consts, (state, extras), pem.cfg.nc)
    step_least = bound(
        count_ops(lambda: fs.step_plain(cell_state, cell_extras, cell_consts, pem.cfg,
                                        fs.Physics(pem.cfg, pem.cfg.nc))),
        4 * (2 * cell_state.numel() + cell_extras.numel() + cell_consts["nu_anom"].numel()
             + cell_consts["omega_ce"].numel() + batch * (fs.P_ICIR + 1)
             + _kernels.rate_coefficients(pem.cfg).size))
    log(f"[11 step timing] step B={batch}: {step_ms * 1e3:.2f} us/launch on the card "
        f"({step_paced_ms * 1e3:.2f} us/launch at the host's launch pace), plain {step_plain_ms:.2f} ms; "
        f"{step_least['ops']:.3e} ops and {step_least['bytes']:.3e} bytes per launch -> bound "
        f"{step_least['bound_ms'] * 1e3:.2f} us (ops {step_least['ops_ms'] * 1e3:.2f}, bytes "
        f"{step_least['bytes_ms'] * 1e3:.2f}) ({time.perf_counter() - t0:.2f} s)")
    del params, consts, state, prof, sacc, extras, cell_consts, cell_state, cell_extras

    # ---- 12-13. the lax solver
    lax = lax_phases(kstep_ms / K * 1e3)
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
    # ---- 22. the plume's kernel
    plume_rec = plume_phase()

    kernels = [{
        "name": "kstep", "instantiation": kname, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches["kstep"], "launches_wrapper_path": wrapper_launches["kstep"],
        "launches_system": systems["spt100"]["kstep_launches"], "launches_h9": systems["h9"]["kstep_launches"],
        "launches_uq_predictive": uq["predictive"]["kstep_launches"],
        "launches_two_shards": parallel["two_shards"]["kstep_launches"], "launches_bench": bench["kstep_launches"],
        "launches_gen_data": workflow["gen_data"]["kstep_launches"],
        "launches_fit_surr": workflow["fit_surr"]["kstep_launches"],
        **{f"launches_{k}": v for k, v in studies["launches"].items() if not k.startswith("diagnose_breathing")},
        **{f"launches_{k}": v for k, v in parity_sweep["launches"].items()},
        "max_scaled_err": kstep_errs["plain"][0], "max_abs_err": kstep_errs["plain"][1],
        "max_scaled_err_trace": kstep_errs["trace"][0], "max_scaled_err_two_group": kstep_errs["two_group"][0],
        "scaled_err_tolerance": STATE_RTOL, "ms": kstep_ms, "plain_ms": kstep_plain_ms,
        **{k: kstep_least[k] for k in ("bound_ms", "bound_by")}, "ops_per_row_step": kstep_least["ops_per_step"] / batch,
        "library_ms": None, "blocks_per_sm": blocks_per_sm, "barriers_per_step": barriers,
        "sass_instructions": len(sass), "sass_instructions_per_step": step_insns, "sm_clock_mhz": sm_mhz,
        "issue_us_per_step": issue_us,
    }, *low_fidelity_kernels, {
        "name": "step", "route": "cuda", "source": STEP_SOURCE, "replaces": STEP_REPLACES,
        "launches": step_launches["step"], "launches_graphed": step_launches["step"],
        "launches_eager": one_step_rec["eager"]["launches"]["step"],
        "us_per_step_graphed": one_step_rec["graphed"]["us_per_step"],
        "us_per_step_graphed_replays": one_step_rec["graphed"]["replay_us_per_step"],
        "card_busy_us_per_step_graphed": one_step_rec["graphed"]["card_busy_us_per_step"],
        "us_per_step_eager": one_step_rec["eager"]["us_per_step"],
        "max_abs_err": step_abs, "max_scaled_err": step_err, "scaled_err_tolerance": STATE_RTOL,
        "ms": step_ms, "host_paced_ms": step_paced_ms, "plain_ms": step_plain_ms,
        "bound_ms": step_least["bound_ms"], "bound_by": step_least["bound_by"], "library_ms": None,
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
    print(json.dumps({"systems": systems}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
