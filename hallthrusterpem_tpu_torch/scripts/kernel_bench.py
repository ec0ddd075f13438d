"""Micro-benchmark of the K-step discharge solver (the JAX package's
``scripts/kernel_bench.py``): the production configuration (200 cells, 3
charge states, dt 5e-9 s) at batch B for ``nsteps`` steps through
``fused_step.simulate_batch_multi``, which launches the ``kstep`` CUDA kernel
ceil(nsteps / 50) times. Three repetitions follow a warm-up run, each timed by
CUDA events around the whole solve; it prints the µs a step of each. On the
CPU (``--device cpu``) the plain version runs, timed by the host clock.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.kernel_bench [B] [nsteps] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("batch", type=int, nargs="?", default=1024)
parser.add_argument("nsteps", type=int, nargs="?", default=20000)
parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")

#: timed repetitions after the warm-up
REPS = 3


def bench_inputs(batch: int, nsteps: int, device) -> tuple:
    """``(cfg, params, base_B)``: 200 cells, 3 charge states, dt 5e-9 s, a
    synthetic 160 G field peaked at the channel exit, V_d uniform in 250-350 V
    from ``default_rng(0)``."""
    from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig, make_params

    cfg = SolverConfig(num_cells=200, ncharge=3, dt=5e-9, duration=nsteps * 5e-9,
                       average_start_time=nsteps // 2 * 5e-9)
    z = cfg.cell_centers()
    s = np.where(z < 0.025, 0.011, 0.018)
    base_B = torch.as_tensor(np.asarray(0.016 * np.exp(-0.5 * ((z - 0.025) / s) ** 2), np.float32), device=device)
    rng = np.random.default_rng(0)
    params = make_params({
        "V_d": torch.as_tensor(rng.uniform(250, 350, batch).astype(np.float32), device=device),
        "V_cc": 30.0, "mdot_a": 5e-6, "P_b": 1e-5,
    }, device=device)
    return cfg, params, base_B


def timed(fn, device) -> tuple:
    """``(result, ms)``: CUDA events on a card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None) -> dict:
    """Returns ``{"batch", "nsteps", "launches", "reps": [{"ms", "us_per_step",
    "finite", "mean_T_mN"}], "us_per_step"`` (the least over the timed reps),
    ``"device"}``."""
    from hallthrusterpem_tpu_torch.models.thruster import _kernels
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.utils import resolve_device

    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg, params, base_B = bench_inputs(args.batch, args.nsteps, device)
    run = lambda: fs.simulate_batch_multi(params, base_B, cfg)
    run()  # warm-up: builds or loads the kernel, fills the caches
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    reps = []
    _kernels.reset_counts()
    for rep in range(REPS):
        out, ms = timed(run, device)
        th = out["thrust"].cpu().numpy()
        reps.append({"ms": ms, "us_per_step": ms * 1e3 / args.nsteps,
                     "finite": float(np.isfinite(th).mean()), "mean_T_mN": float(np.nanmean(th) * 1e3)})
        print(f"rep{rep}: {ms / 1e3:.2f} s total, {reps[-1]['us_per_step']:.1f} us/step "
              f"(B={args.batch}, finite={reps[-1]['finite']:.2f}, mean T={reps[-1]['mean_T_mN']:.1f} mN; {where})")
    launches = _kernels.launch_counts["kstep"] // REPS
    return {"batch": args.batch, "nsteps": args.nsteps, "launches": launches, "reps": reps,
            "us_per_step": min(r["us_per_step"] for r in reps), "device": where}


if __name__ == "__main__":
    main()
