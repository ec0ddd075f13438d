"""Breathing-mode diagnostic: spatiotemporal snapshots of one nominal
discharge (the JAX package's ``scripts/diagnose_breathing.py``).

Runs one SPT-100 operating point and records decimated snapshots of the state
(neutral and plasma density, Te, the first ion velocity, the circuit current,
the exit beam current and the exit ion densities by charge state) every
``--every`` steps, so that the limit-cycle phases (ionization burst ->
expulsion -> quench -> neutral refill) can be inspected. Prints the cycle
statistics and the dominant breathing frequency of the beam current.

Two routes, named in the output: when ``--every`` is a multiple of the K-step
kernel's K = 50 and the kernel takes the config, the snapshots are read from
the K-step state between launches (on the card, ``kstep``); otherwise the lax
solver's ``make_step`` runs the steps (on the card as one replayed CUDA
graph of ``--every`` steps), as the JAX package does.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.diagnose_breathing [--cells 100] [--ncharge 1]
      [--duration 1e-3] [--every 100] [--vd 300] [--mdot 5.16e-6] [--cpu | --device cpu] [--npz FILE]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--cells", type=int, default=100)
parser.add_argument("--ncharge", type=int, default=1)
parser.add_argument("--duration", type=float, default=1.0e-3)
parser.add_argument("--every", type=int, default=100, help="snapshot stride (steps)")
parser.add_argument("--vd", type=float, default=300.0)
parser.add_argument("--mdot", type=float, default=5.16e-6)
parser.add_argument("--u-n", type=float, default=300.0)
parser.add_argument("--a1", type=float, default=0.00625)
parser.add_argument("--a2", type=float, default=0.0625)
parser.add_argument("--c-w", type=float, default=1.0)
parser.add_argument("--cpu", action="store_true", help="run on the CPU (the same as --device cpu)")
parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
parser.add_argument("--plume", action="store_true", help="solve_plume + divergence correction")
parser.add_argument("--shift", action="store_true", help="LogisticPressureShift (reference z0=-0.031)")
parser.add_argument("--circuit-r", type=float, default=0.0, help="cathode-line resistance [Ohm]")
parser.add_argument("--circuit-l", type=float, default=0.0, help="cathode-line inductance [H]")
parser.add_argument("--implicit-inelastic", action="store_true")
parser.add_argument("--shift-dz", type=float, default=0.2)
parser.add_argument("--te-cath", type=float, default=3.0)
parser.add_argument("--l-t", type=float, default=0.003)
parser.add_argument("--npz", type=str, default="", help="save snapshots to this .npz")

#: the snapshot arrays, in the JAX package's order
SNAP_KEYS = ("nn", "ne", "Te", "u1", "I_d", "I_B", "rho_i_ex")


def solver_inputs(args, device) -> tuple:
    """``(cfg, params, base_B)`` of the one operating point (batch of one)."""
    from hallthrusterpem_tpu_torch.models.thruster import _load_bfield
    from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig, make_params
    from hallthrusterpem_tpu_torch.utils import load_thruster

    cfg = SolverConfig(
        num_cells=args.cells, ncharge=args.ncharge, dt=5e-9,
        duration=args.duration, average_start_time=args.duration / 2,
        solve_plume=args.plume, apply_thrust_divergence_correction=args.plume,
        pressure_shift="LogisticPressureShift" if args.shift else "none",
        implicit_inelastic=args.implicit_inelastic,
    )
    base_B = torch.as_tensor(_load_bfield(load_thruster("SPT-100"), cfg), dtype=torch.float32, device=device)
    params = make_params({
        "V_d": args.vd, "mdot_a": args.mdot, "V_cc": 30.0, "P_b": 1e-5,
        "u_n": args.u_n, "a1": args.a1, "a2": args.a2, "c_w": args.c_w,
        "shift_z0": -0.03104, "shift_dz": args.shift_dz, "T_e_cath": args.te_cath,
        "l_t": args.l_t, "circuit_R": args.circuit_r, "circuit_L": args.circuit_l,
    }, batch_shape=(1,), device=device)
    return cfg, params, base_B


def snapshot(cfg, rho_n, rho_i, mom_i, nE, I_cir) -> dict:
    """One snapshot of a batch: ``rho_n`` (B, G, NC), ``rho_i`` and ``mom_i``
    (B, Z, NC), ``nE`` (B, NC), the circuit current ``I_cir`` (B,)."""
    mi = cfg.mi
    zq = torch.arange(1, cfg.ncharge + 1, dtype=torch.float32, device=rho_i.device)
    ni = rho_i / mi
    ne = torch.sum(zq[:, None] * ni, dim=1)
    Te = (2.0 / 3.0) * nE / torch.clamp(ne, min=1e12)
    u1 = mom_i[:, 0] / torch.clamp(rho_i[:, 0], min=1e10 * mi)
    # instantaneous exit quantities
    ex = cfg.nc - 2
    r_ex, m_ex = rho_i[:, :, ex], mom_i[:, :, ex]
    I_B = cfg.geometry.channel_area * 1.602176634e-19 * torch.sum(
        zq * r_ex / mi * m_ex / torch.clamp(r_ex, min=1e10 * mi), dim=1)
    return {"nn": torch.sum(rho_n, dim=1) / mi, "ne": ne, "Te": Te, "u1": u1,
            "I_d": I_cir, "I_B": I_B, "rho_i_ex": r_ex / mi}


def run_kstep(params, base_B, cfg, every: int, n_snap: int) -> dict:
    """``n_snap`` snapshots read from the K-step state every ``every`` steps:
    (n_snap, B, ...) tensors on the inputs' device."""
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs

    K = fs.INNER_STEPS
    consts, state, prof, sacc = fs.init_carry(params, base_B, cfg)
    physics = fs.Physics(cfg) if state.device.type == "cpu" else None
    Z, NC = cfg.ncharge, cfg.nc
    snaps = []
    i0 = 0
    for _ in range(n_snap):
        for _ in range(every // K):
            fs.kstep(state, prof, sacc, consts, i0, K, cfg, physics)
            i0 += K
        s = state[:, :, :NC]
        rho_n = s[[0] + [2 + 2 * Z] * (cfg.neutral_groups - 1)].transpose(0, 1)
        snaps.append(snapshot(cfg, rho_n, s[2:2 + 2 * Z:2].transpose(0, 1), s[3:3 + 2 * Z:2].transpose(0, 1),
                              s[1], sacc[:, fs.A_ICIR].clone()))
    return {k: torch.stack([sn[k] for sn in snaps]) for k in SNAP_KEYS}


def run_lax(params, base_B, cfg, every: int, n_snap: int) -> dict:
    """``n_snap`` snapshots of the lax solver's carry every ``every`` steps
    (on the card one CUDA graph of ``every`` steps, replayed)."""
    from hallthrusterpem_tpu_torch.models.thruster import solver

    run = solver.stepper(params, base_B, solver._init_batch(params, base_B, cfg), cfg)
    snaps = []
    for _ in range(n_snap):
        run.advance(every)
        rho_n, rho_i, mom_i, nE, I_cir = run.carry[0]
        snaps.append(snapshot(cfg, rho_n, rho_i, mom_i, nE, I_cir.clone()))
    return {k: torch.stack([sn[k] for sn in snaps]) for k in SNAP_KEYS}


def statistics(snaps: dict, cfg, every: int) -> dict:
    """Print and return the cycle statistics of the second half of the
    snapshots (numpy, (n_snap, ...) for the one operating point)."""
    n_snap = len(snaps["I_B"])
    nn, ne, Te = snaps["nn"], snaps["ne"], snaps["Te"]
    z = np.asarray(cfg.cell_centers())
    ch = z <= cfg.geometry.channel_length
    half = n_snap // 2
    ib = snaps["I_B"][half:]
    stats = {"n_snap": n_snap, "dt_snap_us": every * cfg.dt * 1e6,
             "I_B": {"mean": float(ib.mean()), "median": float(np.median(ib)),
                     "p10": float(np.percentile(ib, 10)), "p90": float(np.percentile(ib, 90)),
                     "max": float(ib.max())}}
    print(f"# {n_snap} snapshots, dt_snap = {every * cfg.dt * 1e6:.2f} us")
    print(f"exit beam current I_B: mean {ib.mean():.2f} median {np.median(ib):.2f} "
          f"p10 {np.percentile(ib, 10):.2f} p90 {np.percentile(ib, 90):.2f} max {ib.max():.2f} A")
    # dominant breathing frequency from the I_B spectrum
    y = ib - ib.mean()
    if len(y) > 16:
        f = np.fft.rfftfreq(len(y), d=every * cfg.dt)
        P = np.abs(np.fft.rfft(y)) ** 2
        stats["dominant_kHz"] = float(f[1 + np.argmax(P[1:])] / 1e3)
        print(f"dominant frequency: {stats['dominant_kHz']:.1f} kHz")
    stats["Te_channel"] = {"mean": float(Te[half:, ch].mean()), "max": float(Te[half:].max())}
    stats["nn_channel_min"] = {"median": float(np.median(nn[half:, ch].min(axis=1))),
                               "min": float(nn[half:, ch].min())}
    stats["ne_peak"] = {"median": float(np.median(ne[half:].max(axis=1))), "max": float(ne[half:].max())}
    print(f"channel-average Te: mean {Te[half:, ch].mean():.1f} max {Te[half:].max():.1f} eV")
    print(f"channel-min nn: median {np.median(nn[half:, ch].min(axis=1)):.2e} "
          f"min {nn[half:, ch].min():.2e} m^-3")
    print(f"peak ne: median {np.median(ne[half:].max(axis=1)):.2e} max {ne[half:].max():.2e}")
    if cfg.ncharge > 1:
        rex = snaps["rho_i_ex"][half:]
        tot = rex.sum(axis=1, keepdims=True)
        fr = (rex / np.maximum(tot, 1e-30)).mean(axis=0)
        stats["exit_charge_fractions"] = fr.tolist()
        print("exit charge-state fractions:", np.array2string(fr, precision=3))
    return stats


def main(argv=None) -> dict:
    """Returns ``{"route"`` ("kstep" or "lax"), ``"snaps"`` (numpy,
    (n_snap, ...)), ``"t", "z", "stats", "cfg"}``."""
    from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
    from hallthrusterpem_tpu_torch.models.thruster import uses_lax_solver
    from hallthrusterpem_tpu_torch.utils import resolve_device

    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    cfg, params, base_B = solver_inputs(args, device)
    every = args.every
    n_snap = cfg.num_steps // every
    if n_snap < 1:
        raise ValueError(f"--every {every} exceeds the run's {cfg.num_steps} steps: no snapshot")
    # the K-step state between launches, for a stride of whole launches on a config the kernel takes
    route = "kstep" if every % fs.INNER_STEPS == 0 and not uses_lax_solver(cfg) else "lax"
    run = run_kstep if route == "kstep" else run_lax
    snaps = {k: v[:, 0].cpu().numpy() for k, v in run(params, base_B, cfg, every, n_snap).items()}
    t = (np.arange(n_snap) + 1.0) * every * cfg.dt
    z = np.asarray(cfg.cell_centers())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# route: {route} ({'snapshots between K-step launches' if route == 'kstep' else 'lax make_step'}, "
          f"{where})")
    stats = statistics(snaps, cfg, every)
    if args.npz:
        np.savez(args.npz, t=t, z=z, **snaps)
        print(f"saved {args.npz}")
    return {"route": route, "snaps": snaps, "t": t, "z": z, "stats": stats, "cfg": cfg}


if __name__ == "__main__":
    main()
