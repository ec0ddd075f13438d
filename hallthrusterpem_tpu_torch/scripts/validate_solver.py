"""Solver validation sweep: the SPT-100 performance map against published
trends (the JAX package's ``scripts/validate_solver.py``).

Runs the discharge solver over discharge voltage x anode mass flow at the
pem_v0 nominal calibration, through ``dispatch_solver`` (the K-step kernel on
the card at the default 100 cells), prints the map (thrust, currents,
efficiencies, exit velocity) with the rows the wrapper's physicality guards
would NaN-mask flagged, and asserts the trends over the physical rows: thrust
broadly rises with V_d and rises with mass flow. Published SPT-100 anchors
(Sankovic et al. 1993): T ~= 83 mN, I_d ~= 4.5 A at 300 V / 5.16 mg/s.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.validate_solver [--duration 6e-4] [--cells 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--duration", type=float, default=6e-4)
parser.add_argument("--cells", type=int, default=100)
parser.add_argument("--ncharge", type=int, default=1)
parser.add_argument("--cpu", action="store_true", help="run on the CPU (the same as --device cpu)")
parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")

#: the sweep grid: V_d [V] x anode mass flow [kg/s]
SWEEP_VD = np.array([200.0, 250.0, 300.0, 350.0, 400.0])
SWEEP_MDOT = np.array([3.5e-6, 5.16e-6])
#: the pem_v0 nominal calibration (pem_v0_SPT-100 inputs) and the cathode-line
#: facility filter of its config
NOMINAL = {
    "V_cc": 31.9, "P_b": 1e-5,
    "u_n": 141.24234, "c_w": 1.0, "l_t": 1.87915e-3, "T_e_cath": 1.32721,
    "a1": 0.00680237, "a2": 14.645 * 0.00680237,
    "shift_dz": 0.4, "shift_z0": -0.03104, "shift_pstar": 56.86006e-6,
    "circuit_R": 0.5,
}


def sweep_inputs(duration: float = 6e-4, cells: int = 100, ncharge: int = 1, device=None):
    """``(cfg, params, base_B, VD, MD)`` of the sweep: the CFL-consistent dt
    ``min(5e-9, 0.2 dz / u_fast)`` of Xe at ``ncharge`` accelerated through 400 V,
    the quasi-1D plume, the thrust divergence correction and the logistic
    pressure shift."""
    from hallthrusterpem_tpu_torch.models.thruster import _load_bfield
    from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig, make_params
    from hallthrusterpem_tpu_torch.utils import load_thruster, resolve_device

    device = resolve_device(device)
    dz = 0.08 / (cells + 1)
    u_fast = float(np.sqrt(2 * ncharge * 1.602e-19 * 400.0 / 2.18e-25))
    dt = min(5e-9, 0.2 * dz / u_fast)
    cfg = SolverConfig(num_cells=cells, ncharge=ncharge, dt=dt, duration=duration,
                       average_start_time=duration / 2, solve_plume=True,
                       apply_thrust_divergence_correction=True, pressure_shift="LogisticPressureShift")
    base_B = torch.as_tensor(_load_bfield(load_thruster("SPT-100"), cfg), dtype=torch.float32, device=device)
    VD, MD = np.meshgrid(SWEEP_VD, SWEEP_MDOT, indexing="ij")
    params = make_params(dict(NOMINAL, V_d=torch.as_tensor(VD.ravel(), dtype=torch.float32),
                              mdot_a=torch.as_tensor(MD.ravel(), dtype=torch.float32)), device=device)
    return cfg, params, base_B, VD, MD


def sweep(duration: float = 6e-4, cells: int = 100, ncharge: int = 1, device=None) -> dict:
    """Run the sweep: ``{"cfg", "VD", "MD", "out"`` (the solver's outputs as
    numpy), ``"bad"`` (the rows the wrapper's guards reject: a negative beam or
    discharge current or mass efficiency, a beam current over 1.5 Z e mdot /
    m_i, a non-finite thrust), ``"wall_s"}``."""
    from hallthrusterpem_tpu_torch.constants import FUNDAMENTAL_CHARGE
    from hallthrusterpem_tpu_torch.models.thruster import dispatch_solver

    cfg, params, base_B, VD, MD = sweep_inputs(duration, cells, ncharge, device)
    t0 = time.perf_counter()
    out = {k: v.cpu().numpy() for k, v in dispatch_solver(params, base_B, cfg).items()}
    wall = time.perf_counter() - t0
    i_max = 1.5 * cfg.ncharge * FUNDAMENTAL_CHARGE * MD.ravel() / cfg.mi
    bad = ((out["ion_current"] < 0) | (out["discharge_current"] < 0)
           | (out["mass_eff"] < 0) | (out["ion_current"] > i_max)
           | ~np.isfinite(out["thrust"]))
    return {"cfg": cfg, "VD": VD, "MD": MD, "out": out, "bad": bad, "wall_s": wall}


def check_trends(res: dict) -> int:
    """Assert the trends over the physical rows; returns their count."""
    T = np.where(res["bad"], np.nan, res["out"]["thrust"]).reshape(res["VD"].shape)
    col = T[:, 1][np.isfinite(T[:, 1])]
    assert np.all(np.diff(col) > -5e-3), "thrust should broadly increase with V_d"
    both = np.isfinite(T[:, 1]) & np.isfinite(T[:, 0])
    assert np.all(T[both, 1] > T[both, 0]), "thrust should increase with mass flow"
    return int(np.isfinite(T).sum())


def main(argv=None):
    """Returns the sweep's result dict (with ``"physical_rows"``)."""
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    res = sweep(args.duration, args.cells, args.ncharge, device)
    cfg, VD, MD, out, bad = res["cfg"], res["VD"], res["MD"], res["out"], res["bad"]
    where = "cpu" if device == "cpu" else torch.cuda.get_device_name(torch.device(device or "cuda"))
    print(f"# {VD.size} operating points, {cfg.num_steps} steps each, {res['wall_s']:.1f}s wall ({where})")
    print(f"{'V_d':>6} {'mdot':>9} {'T[mN]':>8} {'I_d[A]':>7} {'I_B0[A]':>8} "
          f"{'eta_m':>6} {'eta_a':>6} {'u_exit[km/s]':>12}")
    for i in range(VD.size):
        u_exit = out["ui"][i, 0, -2] / 1e3
        flag = "  <- FAILED (physicality guards; NaN-masked by the PEM)" if bad[i] else ""
        print(f"{VD.ravel()[i]:6.0f} {MD.ravel()[i]:9.2e} {out['thrust'][i]*1e3:8.1f} "
              f"{out['discharge_current'][i]:7.2f} {out['ion_current'][i]:8.2f} "
              f"{out['mass_eff'][i]:6.2f} {out['anode_eff'][i]:6.2f} {u_exit:12.1f}{flag}")
    res["physical_rows"] = check_trends(res)
    print(f"# trend checks passed over {res['physical_rows']}/{VD.size} physical points"
          + (f" ({int(bad.sum())} masked)" if bad.any() else ""))
    return res


if __name__ == "__main__":
    main()
