"""Discharge-current budget at the pem_v0 nominal parameters (the JAX package's
``scripts/diagnose_current.py``).

Decomposes the time-averaged discharge current into beam and electron leak and
prints the generalized-Ohm impedance budget by axial region (anode zone,
ionization zone, magnetic barrier, near plume, far plume), reconstructed from
the solver's time-averaged profiles, with the profile anchors, the power
budget and a z-profile table through the barrier. One sample, through
``dispatch_solver``: the K-step kernel on the card at the default fidelity
(2,2). Published SPT-100 at 300 V / 5.16 mg/s runs T ~= 83 mN, I_d ~= 4.5 A,
current efficiency ~0.75-0.8.

Usage:
  python -m hallthrusterpem_tpu_torch.scripts.diagnose_current [--fidelity 2 2] [--duration 2e-3]
      [--cpu | --device cpu] [--u-n 141.24] [--c-w 1.0] ...
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--fidelity", type=int, nargs=2, default=[2, 2])
parser.add_argument("--duration", type=float, default=2.0e-3)
parser.add_argument("--vd", type=float, default=300.0)
parser.add_argument("--mdot", type=float, default=5.16e-6)
parser.add_argument("--vcc", type=float, default=31.9)
parser.add_argument("--pb", type=float, default=1.0e-5)
# pem_v0 nominal calibration values (pem_v0_SPT-100 inputs)
parser.add_argument("--u-n", type=float, default=141.24234)
parser.add_argument("--l-t", type=float, default=1.87915e-3)
parser.add_argument("--a1", type=float, default=0.00680237)
parser.add_argument("--a2-ratio", type=float, default=14.645, help="c2 = ratio * c1")
parser.add_argument("--te-cath", type=float, default=1.32721)
parser.add_argument("--shift-dz", type=float, default=0.4)
parser.add_argument("--shift-z0", type=float, default=-0.03104)
parser.add_argument("--shift-pstar", type=float, default=56.86006e-6)
parser.add_argument("--c-w", type=float, default=1.0)
parser.add_argument("--cpu", action="store_true", help="run on the CPU (the same as --device cpu)")
parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
parser.add_argument("--no-shift", action="store_true")
parser.add_argument("--implicit-inelastic", action=argparse.BooleanOptionalAction,
                    default=True, help="Newton-linearized inelastic sink (production default)")
parser.add_argument("--circuit-r", type=float, default=0.5,
                    help="cathode-line resistance [Ohm] (pem_v0 config.circuit nominal)")
parser.add_argument("--circuit-l", type=float, default=0.0, help="cathode-line inductance [H]")
parser.add_argument("--wms", type=float, default=None, help="wall_momentum_scale override")
parser.add_argument("--ne-floor", type=float, default=None, help="ne_floor override [m^-3]")
parser.add_argument("--neutral-groups", type=int, default=None, help="1 or 2 (kinetic-tail)")
parser.add_argument("--wall-loss", type=str, default=None, help="sheath|landmark")
parser.add_argument("--b-hat", type=float, default=1.0, help="magnetic-field scale")
parser.add_argument("--anom-depth", type=float, default=0.98, help="barrier-well depth (0..1)")
parser.add_argument("--b-max", type=float, default=None, help="synthetic B peak [T] (regenerates B)")
parser.add_argument("--anode-alpha", type=float, default=None, help="near-anode alpha plateau")
parser.add_argument("--anode-edge-frac", type=float, default=None)
parser.add_argument("--wes", type=float, default=None, help="wall_energy_scale override")
parser.add_argument("--wall-recycling", type=float, default=None, help="returned fraction")
parser.add_argument("--b-sigma-out", type=float, default=None, help="synthetic B outer decay [m]")
parser.add_argument("--see-crossover", type=float, default=None, help="BN SEE crossover [eV]")

#: flag -> SolverConfig field, for the overrides that only apply when given
_CONFIG_OVERRIDES = {"wms": "wall_momentum_scale", "ne_floor": "ne_floor", "neutral_groups": "neutral_groups",
                     "wall_loss": "wall_loss_type", "see_crossover": "see_crossover_eV",
                     "anode_alpha": "anode_alpha", "anode_edge_frac": "anode_edge_frac",
                     "wes": "wall_energy_scale", "wall_recycling": "wall_recycling"}


def solver_inputs(args, device) -> tuple:
    """``(cfg, params, base_B)`` of the one-sample solve the flags describe."""
    from hallthrusterpem_tpu_torch.models.thruster import _load_bfield
    from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig, make_params
    from hallthrusterpem_tpu_torch.models.thruster.mapping import default_model_fidelity
    from hallthrusterpem_tpu_torch.utils import load_thruster

    fid = default_model_fidelity(tuple(args.fidelity), {"config": {
        "discharge_voltage": args.vd, "cathode_coupling_voltage": args.vcc}})
    extra = {field: getattr(args, flag) for flag, field in _CONFIG_OVERRIDES.items()
             if getattr(args, flag) is not None}
    cfg = SolverConfig(
        num_cells=fid["num_cells"], ncharge=fid["ncharge"], dt=fid["dt"],
        duration=args.duration, average_start_time=args.duration / 2,
        solve_plume=True, apply_thrust_divergence_correction=True,
        pressure_shift="none" if args.no_shift else "LogisticPressureShift",
        implicit_inelastic=args.implicit_inelastic, **extra,
    )
    if args.b_max is not None or args.b_sigma_out is not None:
        zc = cfg.cell_centers()
        z_ch = cfg.geometry.channel_length
        s = np.where(zc < z_ch, 0.011, args.b_sigma_out or 0.018)
        base_B = (args.b_max or 0.016) * np.exp(-0.5 * ((zc - z_ch) / s) ** 2)
    else:
        base_B = _load_bfield(load_thruster("SPT-100"), cfg)
    base_B = torch.as_tensor(np.asarray(base_B, np.float32), device=device)
    params = make_params({
        "V_d": args.vd, "mdot_a": args.mdot, "V_cc": args.vcc, "P_b": args.pb,
        "T_e_cath": args.te_cath, "u_n": args.u_n, "l_t": args.l_t,
        "a1": args.a1, "a2": args.a2_ratio * args.a1, "c_w": args.c_w,
        "shift_dz": args.shift_dz, "shift_z0": args.shift_z0,
        "shift_pstar": args.shift_pstar,
        "circuit_R": args.circuit_r, "circuit_L": args.circuit_l,
        "B_hat": args.b_hat, "anom_depth": args.anom_depth,
    }, batch_shape=(1,), device=device)
    return cfg, params, base_B


def report(args, cfg, out: dict, header: str) -> None:
    """Print the budget of one sample's averaged outputs ``out`` (numpy)."""
    from hallthrusterpem_tpu_torch.constants import ELECTRON_MASS, FUNDAMENTAL_CHARGE
    from hallthrusterpem_tpu_torch.models.thruster.rates import K_EN
    from hallthrusterpem_tpu_torch.models.thruster.solver import wall_energy_loss_rate

    e = FUNDAMENTAL_CHARGE
    me = ELECTRON_MASS
    z = out["z"]
    dz = cfg.dz
    A_ch = cfg.geometry.channel_area
    z_ch = cfg.geometry.channel_length

    T = out["thrust"] * 1e3
    I_d = out["discharge_current"]
    I_B0 = out["ion_current"]
    print(header)
    print(f"T = {T:.1f} mN (published ~83)   I_d = {I_d:.2f} A (published ~4.5)   "
          f"I_B0 = {I_B0:.2f} A")
    print(f"I_d std = {out['discharge_current_std']:.2f} A (breathing depth)")
    print(f"leak I_e,exit = I_d - I_B0 = {I_d - I_B0:.2f} A (published ~0.9-1.1)")
    print(f"eta_c = {out['current_eff']:.3f} (published ~0.75-0.8)   "
          f"eta_m = {out['mass_eff']:.3f}   eta_a = {out['anode_eff']:.3f}")

    # ---- impedance budget from time-averaged profiles
    ne = out["ne"]
    Te = out["Tev"]
    nn = out["nn"]
    B = out["B"]
    nu_anom = out["nu_anom"]
    w_ce = e * B / me
    lnL = np.clip(23.0 - 0.5 * np.log(ne * 1e-6) + 1.5 * np.log(Te), 2.0, 30.0)
    nu_ei = 2.9e-12 * ne * lnL / Te**1.5
    nu_en = K_EN.get(cfg.propellant, 2.5e-13) * nn
    in_ch = (z <= z_ch).astype(float)
    nu_ew = cfg.wall_momentum_scale * args.c_w * 1e7 * in_ch
    nu_e = nu_en + nu_ei + nu_anom + nu_ew
    mu = (e / (me * nu_e)) / (1.0 + (w_ce / nu_e) ** 2)

    tand = 0.364
    drz = tand * np.maximum(z - z_ch, 0.0)
    r_o = cfg.geometry.outer_radius + drz
    r_i = np.maximum(cfg.geometry.inner_radius - drz, 0.0)
    AR = (r_o**2 - r_i**2) / (cfg.geometry.outer_radius**2 - cfg.geometry.inner_radius**2)

    dR = 1.0 / (e * ne * mu * A_ch * AR) * dz  # ohms per cell
    i_peak = int(np.argmax(B))
    regions = {
        "anode zone     (z < z_ch-10mm)": z < z_ch - 0.010,
        "ionization     (z_ch-10..-3mm)": (z >= z_ch - 0.010) & (z < z_ch - 0.003),
        "barrier        (z_ch+-3mm)    ": np.abs(z - z_ch) <= 0.003,
        "near plume     (z_ch+3..20mm) ": (z > z_ch + 0.003) & (z <= z_ch + 0.020),
        "far plume      (z > z_ch+20mm)": z > z_ch + 0.020,
    }
    R_tot = float(np.sum(dR[1:-1]))
    print(f"\n# Ohm impedance budget (from averaged profiles): R_total = {R_tot:.2f} Ohm")
    print(f"  (I_d * R_total = {I_d * R_tot:.0f} V vs dV_eff = {args.vd - args.vcc:.0f} V; "
          f"for I_d = 4.5 A the discharge needs R ~ {(args.vd - args.vcc) / 4.5:.0f} Ohm "
          f"net of beam/pressure EMF)")
    for name, m in regions.items():
        m = m & (np.arange(len(z)) >= 1) & (np.arange(len(z)) <= len(z) - 2)
        print(f"  {name}: {np.sum(dR[m]):7.2f} Ohm  ({100 * np.sum(dR[m]) / R_tot:5.1f}%)")

    print("\n# profile anchors (published SPT-100: Te_peak ~20-25 eV just inside exit, "
          "ne_peak ~3-5e17, E_peak ~5e4 V/m near exit)")
    for name, arr in (("Te [eV]", Te), ("ne [m^-3]", ne), ("nn [m^-3]", nn), ("E [V/m]", out["E"])):
        i_pk = int(np.argmax(arr * np.where((z > 0.005) & (z < 0.05), 1.0, 0.0)))
        print(f"  {name:10s}: peak {arr[i_pk]:.3g} at z = {z[i_pk] * 1e3:.1f} mm")
    # ---- power budget (from averaged profiles; steady-state interpretation)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    nu_eps = wall_energy_loss_rate(f64(Te), f64(ne), f64(in_ch), args.c_w, cfg).numpy()
    P_wall = float(np.sum(nu_eps * 1.5 * ne * Te * e * A_ch * AR * dz))
    u_ex = out["ui"][0][-2]
    P_beam = 0.5 * out["thrust"] * u_ex  # ~ (1/2) mdot_i u^2 at matched u
    P_tot = I_d * (args.vd - args.vcc)
    P_iz = I_B0 * 30.0  # ~30 eV effective cost per beam ion (iz + exc chain)
    print(f"\n# power budget: P_in = {P_tot:.0f} W | beam ~{P_beam:.0f} W | "
          f"wall(e) = {P_wall:.0f} W | ionization+exc ~{P_iz:.0f} W | "
          f"residual (anode conv. etc.) ~{P_tot - P_beam - P_wall - P_iz:.0f} W")
    print("# published SPT-100 scale: P_in ~1350 W, beam ~900 W, walls ~200 W, iz ~120 W")

    # compact z-profile table through the barrier/near-plume (the leak region)
    print("\n#   z[mm]    ne[m^-3]   nn[m^-3]  Te[eV]  u1[km/s]  E[V/m]   alpha    dR/dz[Ohm/m]")
    for zmm in (15, 20, 23, 25, 27, 29, 31, 33, 35, 40, 45, 55, 70):
        i = int(np.argmin(np.abs(z - zmm * 1e-3)))
        print(f"  {z[i] * 1e3:6.1f}  {ne[i]:.3g}  {nn[i]:.3g}  {Te[i]:6.1f}  "
              f"{out['ui'][0][i] / 1e3:8.2f}  {out['E'][i]:8.3g}  {nu_anom[i] / w_ce[i]:7.4f} "
              f"{dR[i] / dz:10.1f}")

    i_half = int(np.argmin(np.abs(out["potential"] - 0.5 * (args.vd - args.vcc) - args.vcc)))
    print(f"  potential half-drop at z = {z[i_half] * 1e3:.1f} mm (exit at {z_ch * 1e3:.0f} mm)")
    ui1 = out["ui"][0]
    print(f"  u_i1 exit = {ui1[-2] / 1e3:.1f} km/s; u_i1 max = {ui1.max() / 1e3:.1f} km/s")
    print(f"  B peak at z = {z[i_peak] * 1e3:.1f} mm, B_max = {B[i_peak] * 1e4:.0f} G; "
          f"nu_anom at peak = {nu_anom[i_peak]:.2e} /s (w_ce = {w_ce[i_peak]:.2e})")


def main(argv=None) -> dict:
    """Prints the budget; returns ``{"cfg", "out"`` (the sample's averages as
    numpy), ``"wall_s"}``."""
    from hallthrusterpem_tpu_torch.models.thruster import dispatch_solver
    from hallthrusterpem_tpu_torch.utils import resolve_device

    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    cfg, params, base_B = solver_inputs(args, device)
    t0 = time.time()
    out = {k: v.cpu().numpy()[0] for k, v in dispatch_solver(params, base_B, cfg).items()}
    wall = time.time() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    report(args, cfg, out, f"# fidelity {tuple(args.fidelity)} -> {cfg.num_cells} cells, ncharge {cfg.ncharge}, "
                           f"dt {cfg.dt:.2e}, {cfg.num_steps} steps, {wall:.1f}s wall ({where})")
    return {"cfg": cfg, "out": out, "wall_s": wall}


if __name__ == "__main__":
    main()
