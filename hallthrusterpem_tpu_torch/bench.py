"""Benchmark: coupled-PEM (cathode -> 1-D discharge solver -> plume) throughput
on the card; the port of the repository's ``bench.py``.

    python -m hallthrusterpem_tpu_torch.bench [--device cpu]

Prints ONE JSON line on stdout, ``{"metric", "value", "unit", "vs_baseline"}``,
with ``bench.py``'s keys, metric, unit and baseline: simulated milliseconds of
coupled-PEM physics per wall second per chip for a 1024-sample Monte Carlo at
the pem_v0 operating envelope, ``batch * sim_duration_ms / wall``. The baseline
is ``bench.py``'s HallThruster.jl CPU anchor (``BASELINE.md``): 64 subprocesses
at 30 s per 2 ms simulation, ``64 * 2 / 30`` sim-ms/s.

The workload: ``CoupledPEM(thruster="SPT-100", model_fidelity, duration)``, one
warm-up run (the kernels' build, the allocator), then two timed runs on
``default_coupled_inputs(batch, Generator().manual_seed(trial), spread=0.08)``
for ``trial`` 0 and 1, each timed on the host clock and ended by a host copy of
``T``, which synchronises; the lower wall counts. Any fidelity runs through
``CoupledPEM.forward``'s solver dispatch: (2,2) through the K-step kernel,
(4,2) through the lax solver's CUDA graphs. The line on stderr gives the wall,
the finite rows of ``T``, the card's name and power limit (``nvidia-smi``) and
the K-step kernel's launches in each timed run.

One workload, one try: a failure exits non-zero (there is no second attempt at
a smaller workload). With no CUDA device and no ``--device``, it prints the
null line (``"value": null``, the reason in ``unit``) and exits 1.

Environment knobs, as ``bench.py``'s: BENCH_BATCH (default 1024),
BENCH_DURATION (default 5e-4 s), BENCH_FIDELITY (default "2,2").
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from hallthrusterpem_tpu_torch.models.thruster import _kernels
from hallthrusterpem_tpu_torch.pem import CoupledPEM, default_coupled_inputs
from hallthrusterpem_tpu_torch.utils import resolve_device

METRIC = "coupled_pem_sim_ms_per_sec_per_chip"
#: 64-way HallThruster.jl CPU at 30 s per 2 ms sim (BASELINE.md)
REFERENCE_SIM_MS_PER_SEC = 64.0 * 2.0 / 30.0

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain PyTorch path)")

_clock = time.perf_counter


def unit(batch: int, fidelity: tuple, duration: float) -> str:
    return f"sim-ms/s/chip (batch={batch}, fidelity={fidelity}, {duration:.0e}s sim)"


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return f"device {dev}"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as err:
        smi = [f"power limit not read ({err})"]
    return f"{torch.cuda.get_device_name(dev)}; nvidia-smi: {smi[dev.index or 0] if smi else 'no answer'}"


def run_once(batch: int, duration: float, fidelity: tuple, dev: torch.device) -> dict:
    """The warm-up run and the two timed runs: the lower wall, the finite rows
    and mean of the last run's ``T``, and the K-step launches of each timed run."""
    pem = CoupledPEM(thruster="SPT-100", model_fidelity=fidelity, duration=duration, device=dev)
    inputs = lambda seed: default_coupled_inputs(batch, torch.Generator().manual_seed(seed), spread=0.08,
                                                 device=dev)
    pem(inputs(42))["T"].cpu()  # warm-up
    walls, launches = [], []
    for trial in range(2):
        inp = inputs(trial)
        _kernels.reset_counts()
        t0 = _clock()
        thrust = pem(inp)["T"].cpu().numpy()  # the host copy waits for the card
        walls.append(_clock() - t0)
        launches.append(_kernels.launch_counts["kstep"])
    return {"wall": min(walls), "walls": walls, "n_ok": int(np.isfinite(thrust).sum()),
            "mean_T": float(np.nanmean(thrust)), "kstep_launches": launches, "num_steps": pem.cfg.num_steps}


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:
        print(json.dumps({"metric": METRIC, "value": None, "unit": f"no device to measure ({err})",
                          "vs_baseline": None}), flush=True)
        return 1
    batch = int(os.environ.get("BENCH_BATCH", "1024"))
    duration = float(os.environ.get("BENCH_DURATION", "5e-4"))
    fidelity = tuple(int(t) for t in os.environ.get("BENCH_FIDELITY", "2,2").split(","))

    r = run_once(batch, duration, fidelity, dev)
    evals_per_sec = batch / r["wall"]
    sim_ms_per_sec = evals_per_sec * duration * 1e3
    print(json.dumps({
        "metric": METRIC,
        "value": round(sim_ms_per_sec, 3),
        "unit": unit(batch, fidelity, duration),
        "vs_baseline": round(sim_ms_per_sec / REFERENCE_SIM_MS_PER_SEC, 2),
    }), flush=True)
    print(f"# wall={r['wall']:.2f}s, {r['n_ok']}/{batch} finite, mean T={r['mean_T'] * 1e3:.1f} mN, "
          f"{evals_per_sec:.1f} evals/s at {duration * 1e3:.1f} ms sim "
          f"(= {sim_ms_per_sec / 2:.1f} full-2ms evals/s); walls {r['walls'][0]:.4f} / {r['walls'][1]:.4f} s, "
          f"{r['num_steps']} steps, kstep launches per timed run {r['kstep_launches']}; {card_line(dev)}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
