"""The lax solver: the 1-D discharge on (batch, cells) tensors in plain
PyTorch (the JAX package's ``models/thruster/solver.py``), and the
static-in-time profile helpers the K-step kernel path shares with it.

This is the solver for the configurations the K-step kernel's lane layout does
not hold: grids past 254 cells (model fidelity alpha_0 >= 4) and any
``dtype`` other than float32. It is written batched, with a leading batch axis
(state ``(B, Z, NC)``), where JAX vmaps a one-sample step; every arithmetic
expression keeps the operand order of the JAX model so that the rounding
matches. The step reads no tensor value on the host: its step index is a
tensor on the device, the averaging gate and the I_d(t) trace write are tensor
expressions of it. So on a CUDA device :func:`_segment_batch` captures
``GRAPH_STEPS`` steps once as a CUDA graph and replays it, the counterpart of
JAX's jitted ``lax.scan``; on the CPU it dispatches the steps one by one. It
runs on the device its inputs lie on.

Carry: ``((rho_n (B,G,NC), rho_i (B,Z,NC), mom_i (B,Z,NC), nE (B,NC), I_prev (B,)),
accum, i, failed)`` with ``accum`` a dict of running sums, ``i`` the step
index (a 0-d int64 tensor, the same for every sample) and ``failed`` a (B,) bool.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from hallthrusterpem_tpu_torch import cuda_graph
from hallthrusterpem_tpu_torch.constants import BOLTZMANN_CONSTANT, ELECTRON_MASS, FUNDAMENTAL_CHARGE
from hallthrusterpem_tpu_torch.models.thruster.config import (
    SolverConfig,
    background_neutral_ingestion_flux,
)
from hallthrusterpem_tpu_torch.models.thruster.rates import (
    K_EN,
    build_reactions,
    derivative_table,
    excitation_log_poly,
    excitation_table,
    lookup_rate,
)
from hallthrusterpem_tpu_torch.ops.tridiag import tridiag_solve
from hallthrusterpem_tpu_torch.tracing import count

_E = FUNDAMENTAL_CHARGE
_ME = ELECTRON_MASS
_KB = BOLTZMANN_CONSTANT


def _pressure_shift_m(p: dict, cfg: SolverConfig, z_ch: float):
    """Downstream shift [m] of the anomalous profile against background pressure:
    ``(z0 + dz (1 - sigmoid(alpha (P/P* - 1)))) L_ch`` (LogisticPressureShift)."""
    if cfg.pressure_shift == "none":
        return 0.0
    sig = torch.sigmoid(p["shift_alpha"] * (p["P_b"] / p["shift_pstar"] - 1.0))
    if cfg.pressure_shift == "SimpleLogisticShift":
        return p["shift_dz"] * (1.0 - sig) * z_ch
    return (p["shift_z0"] + p["shift_dz"] * (1.0 - sig)) * z_ch


def wall_energy_loss_rate(Te, ne, in_channel, c_w, cfg: SolverConfig, lnTe=None, rs_te=None):
    """Electron-wall energy-loss frequency nu_eps [1/s]: the volumetric loss is
    ``nu_eps * (3/2 n Te)``. "sheath" is a BN secondary-emission wall sheath;
    "landmark" is ``1e7 exp(-20/Te)`` inside the channel."""
    if cfg.wall_loss_type == "sheath":
        if lnTe is not None:
            gamma = torch.clamp(1.4 * torch.exp(0.576 * (lnTe - float(np.log(cfg.see_crossover_eV)))),
                                max=cfg.see_gamma_max)
        else:
            gamma = torch.clamp(1.4 * (Te * (1.0 / cfg.see_crossover_eV)) ** 0.576,
                                max=cfg.see_gamma_max)
        one_m_g = 1.0 - gamma
        phi_w_over_te = torch.clamp(
            torch.log(one_m_g * float(np.sqrt(cfg.mi / (2 * np.pi * _ME)))), min=0.0)
        coef = float(cfg.wall_energy_scale * 0.6 * np.sqrt(_E / cfg.mi)
                     / cfg.geometry.channel_gap / 1.5)
        sqrt_te = (Te * rs_te) if rs_te is not None else torch.sqrt(Te)
        return (coef * c_w) * sqrt_te / one_m_g * (2.0 + phi_w_over_te) * in_channel
    return (cfg.wall_energy_scale * c_w * 1e7 * torch.exp(torch.full_like(Te, -20.0) / Te)
            * in_channel)


def anomalous_profile(p: dict, z: torch.Tensor, cfg: SolverConfig) -> torch.Tensor:
    """Dimensionless anomalous collision coefficient alpha(z), (batch, NC) for
    (batch,) parameters and the (NC,) cell centres: TwoZoneBohm (with the
    transport-barrier well and near-anode plateau) or GaussianBohm. Adds the
    batch to the counter ``gaussian_bohm_rows`` for a GaussianBohm profile."""
    col = lambda k: p[k][:, None]
    z_ch = cfg.geometry.channel_length
    shift = _pressure_shift_m(p, cfg, z_ch)
    shift = shift[:, None] if isinstance(shift, torch.Tensor) else shift
    if cfg.anom_model == "GaussianBohm":
        count(gaussian_bohm_rows=p["center"].shape[0])
        zc = col("center") + shift
        return col("hall_max") + (col("hall_min") - col("hall_max")) * torch.exp(
            -0.5 * ((z - zc) / torch.clamp(col("width"), min=1e-4)) ** 2)
    z_tr = z_ch + shift
    w = 0.5 * (1.0 + torch.tanh(2.0 * (z - z_tr) / torch.clamp(col("l_t"), min=1e-4)))
    alpha = col("a1") + (col("a2") - col("a1")) * w
    if cfg.anom_barrier_width > 0:
        # transport-barrier well at the (shifted) field peak, pulling the profile
        # toward the floor a1 (1 - depth); per-sample width when anom_width > 0
        aw = col("anom_width")
        width = torch.where(aw > 0, aw, cfg.anom_barrier_width)
        g = torch.exp(-0.5 * ((z - z_tr) / width) ** 2)
        floor = col("a1") * (1.0 - torch.clamp(col("anom_depth"), 0.0, 0.98))
        alpha = alpha + g * (floor - alpha)
    if cfg.anode_alpha > 0:
        # near-anode conductive plateau with a logistic roll-off
        edge = cfg.anode_edge_frac * z_ch + shift
        roll = 0.5 * (1.0 - torch.tanh((z - edge) / cfg.anode_edge_width))
        alpha = alpha + cfg.anode_alpha * roll
    return alpha


# ======================================================================================
# the lax solver
# ======================================================================================
ACCUM_KEYS = ("thrust", "I_d", "I_d2", "I_B0", "mdot_ion", "u_exit1", "ui", "Te", "ne", "E", "nn")


def _dtype(cfg: SolverConfig) -> torch.dtype:
    return torch.float64 if cfg.dtype == "float64" else torch.float32


@functools.lru_cache(maxsize=None)
def _rate_tables(propellant: str, ncharge: int):
    """Reaction tables as numpy: ``[(z_from, z_to, energy, table, dtable)]`` for
    each ionization reaction, then ``(table, energy, dtable)`` of excitation
    (the fits take ~0.2 s and depend on nothing else)."""
    rxn = tuple((r.z_from, r.z_to, r.energy_eV, np.asarray(r.table), derivative_table(r))
                for r in build_reactions(propellant, ncharge))
    ex_table, ex_energy = excitation_table(propellant)
    return rxn, (ex_table, ex_energy, derivative_table(excitation_log_poly(propellant)[0]))


def _static_profiles(params: dict, base_B, cfg: SolverConfig):
    """Per-sample parameters in the config's dtype, the cell centres, the
    B-field (B, NC) and the anomalous collision frequency (B, NC)."""
    f = _dtype(cfg)
    dev = params["V_d"].device
    p = {k: v.to(f) for k, v in params.items()}
    z = torch.as_tensor(cfg.cell_centers(), dtype=f, device=dev)
    B = base_B.to(device=dev, dtype=f)[None, :] * p["B_hat"][:, None]
    omega_ce = _E * B / _ME
    nu_anom = anomalous_profile(p, z, cfg) * omega_ce
    return p, z, B, omega_ce, nu_anom


def _add_interior(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x`` with ``v`` added to its interior cells ``[..., 1:-1]``."""
    return torch.cat([x[..., :1], x[..., 1:-1] + v, x[..., -1:]], dim=-1)


def make_step(params: dict, base_B: torch.Tensor, cfg: SolverConfig):
    """``(step, carry0)`` for a batch: ``step(carry) -> (carry', I_d)`` advances
    every sample one timestep. ``params`` are (B,) tensors (``make_params``),
    ``base_B`` the (NC,) unscaled B-field on the cell centres."""
    f = _dtype(cfg)
    NC, Z, G = cfg.nc, cfg.ncharge, cfg.neutral_groups
    dz = cfg.dz
    dt = cfg.dt
    mi = cfg.mi
    A_ch = cfg.geometry.channel_area
    gap = cfg.geometry.channel_gap
    p, z, _, omega_ce, nu_anom = _static_profiles(params, base_B, cfg)
    dev = z.device
    nB = p["V_d"].shape[0]
    col = lambda k: p[k][:, None]
    zq = torch.arange(1, Z + 1, dtype=f, device=dev)[:, None]  # (Z, 1) charge numbers
    in_channel = (z <= cfg.geometry.channel_length).to(f)

    a_i = float(np.sqrt(_KB * cfg.ion_temp_K / mi))
    mdot_in = p["mdot_a"] + background_neutral_ingestion_flux(p["P_b"], p["f_n"], cfg)
    u_n = torch.clamp(p["u_n"], min=10.0)
    if G == 2:
        fr = cfg.fast_neutral_fraction
        u_g = torch.stack([cfg.slow_neutral_ratio * u_n, cfg.fast_neutral_ratio * u_n], dim=1)
        inj_frac = torch.tensor([1.0 - fr, fr], dtype=f, device=dev)
    else:
        u_g = u_n[:, None]
        inj_frac = torch.ones((1,), dtype=f, device=dev)
    rho_inj_g = inj_frac * mdot_in[:, None] / (A_ch * u_g)  # (B, G)

    rxn_np, (ex_np, ex_energy, ex_d_np) = _rate_tables(cfg.propellant, Z)
    tab = lambda a: torch.as_tensor(a, dtype=f, device=dev)
    reactions = [(z_from, z_to, energy, tab(t), tab(dt_)) for z_from, z_to, energy, t, dt_ in rxn_np]
    ex_table, ex_dtable = tab(ex_np), tab(ex_d_np)
    k_en = K_EN.get(cfg.propellant, 2.5e-13)
    rho_floor = float(1e10 * mi)
    dV = p["V_d"] - p["V_cc"]

    # ---------------------------------------------------------------- initial state
    z_ch = cfg.geometry.channel_length
    L = cfg.domain[1] - cfg.domain[0]
    rho_n0 = torch.broadcast_to(rho_inj_g[:, :, None], (nB, G, NC)).clone()
    n_i0 = 2e17 + 1e18 * torch.exp(-(((z - z_ch) / (0.3 * z_ch)) ** 2))
    rho_i0 = (n_i0 * mi)[None, :] * (0.25 ** torch.arange(Z, dtype=f, device=dev))[:, None]
    u_bohm0 = torch.sqrt(torch.tensor(_E * 3.0 / mi, dtype=f, device=dev))
    u_exit0 = torch.sqrt(2.0 * _E * torch.clamp(dV, min=50.0) / mi)[:, None]
    frac = torch.clamp((z - 0.5 * z_ch) / (L - 0.5 * z_ch), 0.0, 1.0)
    u_i0 = (-u_bohm0 * (1.0 - frac) + u_exit0 * frac**2)[:, None, :]  # (B, 1, NC)
    mom_i0 = rho_i0 * u_i0
    ne0 = torch.sum(zq * rho_i0 / mi, dim=0)
    Te0 = 3.0 + 0.04 * torch.clamp(dV, min=50.0)[:, None] * torch.exp(-(((z - z_ch) / (0.4 * z_ch)) ** 2))
    nE0 = 1.5 * ne0 * Te0
    I_prev0 = torch.tensor(_E / mi, dtype=f, device=dev) * p["mdot_a"]
    state0 = (rho_n0, torch.broadcast_to(rho_i0, (nB, Z, NC)).clone(), mom_i0, nE0, I_prev0)

    # ---------------------------------------------------------------- plume geometry
    if cfg.solve_plume:
        g = cfg.geometry
        tand = torch.clamp(p["tan_div"], 0.0, 2.0)[:, None]
        drz = tand * torch.clamp(z - g.channel_length, min=0.0)
        r_o_pl = g.outer_radius + drz
        r_i_pl = torch.clamp(g.inner_radius - drz, min=0.0)
        AR = (r_o_pl**2 - r_i_pl**2) / (g.outer_radius**2 - g.inner_radius**2)  # (B, NC)
        inv_AR = 1.0 / AR
        AR_f = 0.5 * (AR[:, :-1] + AR[:, 1:])
        zero = torch.zeros((nB, 1), dtype=f, device=dev)
        dlnA = torch.cat([zero, (AR_f[:, 1:] - AR_f[:, :-1]) / (dz * AR[:, 1:-1]), zero], dim=1)
        cos_div = torch.rsqrt(1.0 + tand[:, 0] * tand[:, 0])
        A_ex = A_ch * AR[:, NC - 2]
    else:
        AR = torch.ones((NC,), dtype=f, device=dev)
        inv_AR = AR
        AR_f = torch.ones((NC - 1,), dtype=f, device=dev)
        dlnA = torch.zeros((NC,), dtype=f, device=dev)
        cos_div = torch.ones((), dtype=f, device=dev)
        A_ex = A_ch * AR[NC - 2]

    L_dt = p["circuit_L"] / torch.tensor(dt, dtype=f, device=dev)
    nu_ew = cfg.electron_wall_losses * cfg.wall_momentum_scale * col("c_w") * 1e7 * in_channel
    wfm = AR_f[..., 0:NC - 2] / AR[..., 1:-1]
    wfp = AR_f[..., 1:NC - 1] / AR[..., 1:-1]
    Te_bc_l = torch.full((nB, 1), cfg.anode_Te, dtype=f, device=dev)
    Te_bc_r = col("T_e_cath")

    def minmod_slope(q):
        if not cfg.reconstruct:
            return torch.zeros_like(q)
        dq = q[..., 1:] - q[..., :-1]
        s = 0.5 * (torch.sign(dq[..., :-1]) + torch.sign(dq[..., 1:])) * torch.minimum(
            torch.abs(dq[..., :-1]), torch.abs(dq[..., 1:]))
        return torch.nn.functional.pad(s, (1, 1))

    def ddz(F):
        return (F[..., 1:] * AR_f[..., None, 1:] - F[..., :-1] * AR_f[..., None, :-1]) / (
            dz * AR[..., None, 1:-1])

    def row_finite(x):
        return torch.isfinite(x).flatten(1).all(dim=1)

    def step(carry):
        (rho_n, rho_i, mom_i, nE, I_prev), accum, i, failed = carry

        # ---- per-sample blow-up flag, then the scrub (NaN/Inf -> in-range values)
        failed = failed | ~(row_finite(rho_n) & row_finite(rho_i) & row_finite(mom_i) & row_finite(nE))
        rho_n = torch.clamp(torch.nan_to_num(rho_n, nan=1e10 * mi, posinf=1e21 * mi, neginf=1e10 * mi),
                            rho_floor, 1e21 * mi)
        rho_i = torch.clamp(torch.nan_to_num(rho_i, nan=1e10 * mi, posinf=1e21 * mi, neginf=1e10 * mi),
                            rho_floor, 1e21 * mi)
        mom_i = torch.clamp(torch.nan_to_num(mom_i), -rho_i * 3e5, rho_i * 3e5)
        nE = torch.clamp(torch.nan_to_num(nE, nan=1.0, posinf=1e22, neginf=1.0), 1.0, 1e23)
        I_prev = torch.clamp(torch.nan_to_num(I_prev), -1e4, 1e4)

        # ---- plasma properties
        ni = rho_i / mi
        ne = torch.clamp(torch.sum(zq * ni, dim=1), min=cfg.ne_floor)
        Te = torch.clamp((2.0 / 3.0) * nE / ne, cfg.Te_min, cfg.Te_max)
        nn_g = rho_n / mi
        nn = torch.clamp(torch.sum(nn_g, dim=1), min=1e6)
        n_share = nn_g / nn[:, None, :]
        u_n_eff = torch.sum(n_share * u_g[:, :, None], dim=1)
        u_i = mom_i / torch.clamp(rho_i, min=rho_floor)

        # ---- collision frequencies & cross-field mobility
        lnL = torch.clamp(23.0 - 0.5 * torch.log(ne * 1e-6) + 1.5 * torch.log(Te), 2.0, 30.0)
        nu_ei = 2.9e-12 * ne * lnL / Te**1.5
        nu_e = k_en * nn + nu_ei + nu_anom + nu_ew
        Omega2 = (omega_ce / nu_e) ** 2
        mu = (_E / (_ME * nu_e)) / (1.0 + Omega2)

        # ---- Ohm's law: direct integration with the RL circuit filter
        j_i = _E * torch.sum(zq * ni * u_i, dim=1)
        pe = ne * Te
        grad_pe = torch.gradient(pe, dim=1)[0] / dz
        enmu = _E * ne * mu
        num_igd = j_i / enmu + grad_pe / ne
        den_igd = inv_AR / enmu
        num_int = torch.sum(num_igd[:, 1:-1], dim=1) * dz
        den_pl = torch.sum(den_igd[:, 1:-1], dim=1) * dz + p["circuit_R"] * A_ch
        den_all = den_pl + L_dt * A_ch
        j_prev = I_prev / A_ch
        j_d = j_prev + (dV + num_int - j_prev * den_pl) / den_all
        if cfg.anode_sheath:
            # one fixed-point pass of the electron-repelling anode sheath
            j_e_th = _E * ne[:, 1] * torch.sqrt(_E * Te[:, 1] / (2.0 * math.pi * _ME))
            j_e_req = torch.maximum(j_d - j_i[:, 1], 1e-6 * j_e_th)
            phi_s = torch.minimum(torch.clamp(Te[:, 1] * torch.log(j_e_th / j_e_req), min=0.0),
                                  0.5 * torch.abs(dV))
            j_d = j_prev + (dV - phi_s + num_int - j_prev * den_pl) / den_all
        I_new = j_d * A_ch
        j_d_loc = j_d[:, None] * inv_AR
        E_z = (j_d_loc - j_i) / enmu - grad_pe / ne

        # ---- heavy-species boundary (ghost) cells
        u_bohm = torch.sqrt(zq[:, 0] * _E * Te[:, 1:2] / mi)  # (B, Z)
        mom_back = torch.sum(torch.clamp(mom_i[:, :, 1], max=0.0), dim=1)
        recyc = torch.cat([-mom_back[:, None], torch.zeros((nB, G - 1), dtype=f, device=dev)], dim=1)
        rho_n_l = (inj_frac * mdot_in[:, None] / A_ch + recyc) / u_g
        rho_n_b = torch.cat([rho_n_l[:, :, None], rho_n[:, :, 1:-1], rho_n[:, :, -2:-1]], dim=2)
        rho_gl = rho_i[:, :, 1]
        u_gl = torch.minimum(u_i[:, :, 1], -cfg.mdot_bohm_fraction * u_bohm)
        rho_i_b = torch.cat([rho_gl[:, :, None], rho_i[:, :, 1:-1], rho_i[:, :, -2:-1]], dim=2)
        mom_i_b = torch.cat([(rho_gl * u_gl)[:, :, None], mom_i[:, :, 1:-1], mom_i[:, :, -2:-1]], dim=2)

        # ---- fluxes on the NC-1 faces: MUSCL minmod reconstruction, HLLE ions
        sl_rn = minmod_slope(rho_n_b)
        rho_nLf = rho_n_b[..., :-1] + 0.5 * sl_rn[..., :-1]
        Fn = u_g[:, :, None] * torch.clamp(rho_nLf, min=rho_floor)
        u_i_b = mom_i_b / torch.clamp(rho_i_b, min=rho_floor)
        sl_r = minmod_slope(rho_i_b)
        sl_u = minmod_slope(u_i_b)
        rL = torch.clamp(rho_i_b[..., :-1] + 0.5 * sl_r[..., :-1], min=rho_floor)
        rR = torch.clamp(rho_i_b[..., 1:] - 0.5 * sl_r[..., 1:], min=rho_floor)
        uL = u_i_b[..., :-1] + 0.5 * sl_u[..., :-1]
        uR = u_i_b[..., 1:] - 0.5 * sl_u[..., 1:]
        mL, mR = rL * uL, rR * uR
        pL, pR = rL * a_i * a_i, rR * a_i * a_i
        sL = torch.clamp(torch.minimum(uL - a_i, uR - a_i), max=0.0)
        sR = torch.clamp(torch.maximum(uL + a_i, uR + a_i), min=0.0)
        FmL, FmR = mL * uL + pL, mR * uR + pR
        ds = torch.clamp(sR - sL, min=1e-8)
        Fr = (sR * mL - sL * mR + sL * sR * (rR - rL)) / ds
        Fm = (sR * FmL - sL * FmR + sL * sR * (mR - mL)) / ds

        rho_n_new = _add_interior(rho_n_b, -dt * ddz(Fn))
        rho_i_new = _add_interior(rho_i_b, -dt * ddz(Fr))
        mom_i_new = _add_interior(mom_i_b, -dt * ddz(Fm))

        # ---- ionization and excitation sources (static unroll over the reactions)
        inelastic = torch.zeros_like(ne)
        dinel_dTe = torch.zeros_like(ne)
        d_rho_n = torch.zeros_like(rho_n)
        d_rho = [torch.zeros_like(ne) for _ in range(Z)]
        d_mom = [torch.zeros_like(ne) for _ in range(Z)]
        for z_from, z_to, energy, table, dtable in reactions:
            k_r = lookup_rate(table, Te)
            n_from = nn if z_from == 0 else ni[:, z_from - 1]
            u_from = u_n_eff if z_from == 0 else u_i[:, z_from - 1]
            R = (ne * k_r) * n_from  # this order stays below the float32 range
            dm = R * mi
            if z_from == 0:
                d_rho_n = d_rho_n - dm[:, None, :] * n_share
            else:
                d_rho[z_from - 1] = d_rho[z_from - 1] + -dm
                d_mom[z_from - 1] = d_mom[z_from - 1] + -dm * u_from
            d_rho[z_to - 1] = d_rho[z_to - 1] + dm
            d_mom[z_to - 1] = d_mom[z_to - 1] + dm * u_from
            contrib = R * energy
            inelastic = inelastic + contrib
            if cfg.implicit_inelastic:
                dinel_dTe = dinel_dTe + contrib * lookup_rate(dtable, Te) / Te
        ex_contrib = (ne * lookup_rate(ex_table, Te)) * nn * ex_energy
        inelastic = inelastic + ex_contrib
        if cfg.implicit_inelastic:
            dinel_dTe = dinel_dTe + ex_contrib * lookup_rate(ex_dtable, Te) / Te
            dinel_dTe = torch.clamp(dinel_dTe, min=0.0)
        d_rho = torch.stack(d_rho, dim=1)
        d_mom = torch.stack(d_mom, dim=1)

        d_mom = d_mom + zq * _E * ni * E_z[:, None, :]  # force density Z e n_i E
        if cfg.solve_plume:
            d_mom = d_mom + rho_i * (a_i * a_i) * dlnA[:, None, :]
        if cfg.ion_wall_losses:
            # lost ions recombine at the wall into the slow neutral group
            u_bohm_z = torch.sqrt(zq * _E * Te[:, None, :] / mi)
            nu_iw = 0.6 * u_bohm_z / gap * in_channel
            d_rho = d_rho - nu_iw * rho_i
            d_mom = d_mom - nu_iw * mom_i
            recycled = cfg.wall_recycling * torch.sum(nu_iw * rho_i, dim=1)
            d_rho_n = torch.cat([d_rho_n[:, :1] + recycled[:, None, :], d_rho_n[:, 1:]], dim=1)

        rho_n_new = torch.clamp(_add_interior(rho_n_new, dt * d_rho_n[..., 1:-1]), min=rho_floor)
        rho_i_new = torch.clamp(_add_interior(rho_i_new, dt * d_rho[..., 1:-1]), min=rho_floor)
        mom_i_new = _add_interior(mom_i_new, dt * d_mom[..., 1:-1])

        # ---- electron energy: backward Euler in Te, one PCR tridiagonal solve
        ne_new = torch.clamp(torch.sum(zq * rho_i_new / mi, dim=1), min=cfg.ne_floor)
        Gamma_e = -(j_d_loc - j_i) / _E
        G_f = 0.5 * (Gamma_e[:, :-1] + Gamma_e[:, 1:])
        mnt = mu * ne * Te
        kappa_f = (10.0 / 9.0) * 0.5 * (mnt[:, :-1] + mnt[:, 1:])
        kf = kappa_f / dz
        Gp = (5.0 / 2.0) * torch.clamp(G_f, min=0.0)
        Gn = (5.0 / 2.0) * torch.clamp(G_f, max=0.0)
        fm, fp = slice(0, NC - 2), slice(1, NC - 1)
        nu_eps = cfg.electron_wall_losses * wall_energy_loss_rate(Te, ne, in_channel, col("c_w"), cfg)
        n_c = ne_new[:, 1:-1]
        sub = (-Gp[:, fm] - kf[:, fm]) * wfm / dz
        sup = (Gn[:, fp] - kf[:, fp]) * wfp / dz
        diag = (1.5 * n_c / dt + ((Gp[:, fp] + kf[:, fp]) * wfp + (kf[:, fm] - Gn[:, fm]) * wfm) / dz
                + nu_eps[:, 1:-1] * 1.5 * n_c)
        q_ohm = (j_d_loc - j_i) * E_z / _E
        rhs = nE[:, 1:-1] / dt + q_ohm[:, 1:-1] - inelastic[:, 1:-1]
        if cfg.implicit_inelastic:
            # Newton linearisation of the inelastic sink about the old Te
            diag = diag + dinel_dTe[:, 1:-1]
            rhs = rhs + dinel_dTe[:, 1:-1] * Te[:, 1:-1]
        rhs = torch.cat([rhs[:, :1] + -sub[:, :1] * Te_bc_l, rhs[:, 1:-1],
                         rhs[:, -1:] + -sup[:, -1:] * Te_bc_r], dim=1)
        sub = torch.cat([torch.zeros_like(sub[:, :1]), sub[:, 1:]], dim=1)
        sup = torch.cat([sup[:, :-1], torch.zeros_like(sup[:, :1])], dim=1)
        Te_int = tridiag_solve(sub, diag, sup, rhs)
        Te_new = torch.clamp(torch.cat([Te_bc_l, Te_int, Te_bc_r], dim=1), cfg.Te_min, cfg.Te_max)
        nE_new = 1.5 * ne_new * Te_new

        # ---- instantaneous QoIs through the exit cross-section, running averages
        ex = NC - 2
        u_exit = mom_i_new[:, :, ex] / torch.clamp(rho_i_new[:, :, ex], min=rho_floor)
        thrust = A_ex * torch.sum(mom_i_new[:, :, ex] * u_exit + rho_i_new[:, :, ex] * a_i**2, dim=1)
        if cfg.apply_thrust_divergence_correction and cfg.solve_plume:
            thrust = thrust * cos_div
        I_d = I_new
        I_B0 = A_ex * _E * torch.sum(zq[:, 0] * rho_i_new[:, :, ex] / mi * u_exit, dim=1)
        mdot_ion = A_ex * torch.sum(mom_i_new[:, :, ex], dim=1)

        # accumulate inside [avg_start_step, num_steps) only: the upper gate makes
        # chunked runs exact when the last chunk overshoots num_steps
        w = ((i >= cfg.avg_start_step) & (i < cfg.num_steps)).to(f)
        ui_prof = mom_i_new / torch.clamp(rho_i_new, min=rho_floor)
        inst = {"thrust": thrust, "I_d": I_d, "I_B0": I_B0, "mdot_ion": mdot_ion,
                "u_exit1": u_exit[:, 0], "ui": ui_prof, "Te": Te, "ne": ne, "E": E_z, "nn": nn}
        new_accum = {k: accum[k] + w * inst[k] for k in inst}
        new_accum["I_d2"] = accum["I_d2"] + w * I_d * I_d
        return ((rho_n_new, rho_i_new, mom_i_new, nE_new, I_new), new_accum, i + 1, failed), I_d

    zeros = lambda *shape: torch.zeros((nB,) + shape, dtype=f, device=dev)
    accum0 = {"thrust": zeros(), "I_d": zeros(), "I_d2": zeros(), "I_B0": zeros(), "mdot_ion": zeros(),
              "u_exit1": zeros(), "ui": zeros(Z, NC), "Te": zeros(NC), "ne": zeros(NC), "E": zeros(NC),
              "nn": zeros(NC)}
    carry0 = (state0, accum0, torch.zeros((), dtype=torch.int64, device=dev),
              torch.zeros((nB,), dtype=torch.bool, device=dev))
    return step, carry0


def _finalize(p: dict, accum: dict, failed, z, nu_anom, B, cfg: SolverConfig) -> dict:
    """Running sums of a batch to its time-averaged outputs; failed rows NaN."""
    nB = failed.shape[0]
    n_avg = float(max(cfg.num_steps - cfg.avg_start_step, 1))
    nanify = lambda v: torch.where(failed.reshape((nB,) + (1,) * (v.ndim - 1)), torch.nan, v / n_avg)
    avg = {k: nanify(v) for k, v in accum.items()}
    thrust, I_d, I_B0 = avg["thrust"], avg["I_d"], avg["I_B0"]
    E_avg = avg["E"]
    phi = p["V_d"][:, None] - torch.cat(
        [torch.zeros_like(E_avg[:, :1]), torch.cumsum(0.5 * (E_avg[:, 1:] + E_avg[:, :-1]) * cfg.dz, dim=1)],
        dim=1)
    return {
        "thrust": thrust,
        "discharge_current": I_d,
        "discharge_current_std": torch.sqrt(torch.clamp(avg["I_d2"] - I_d**2, min=0.0)),
        "ion_current": I_B0,
        "current_eff": I_B0 / I_d,
        "mass_eff": avg["mdot_ion"] / p["mdot_a"],
        "voltage_eff": avg["u_exit1"] ** 2 * cfg.mi / (2 * _E * torch.clamp(p["V_d"], min=1.0)),
        "anode_eff": thrust**2 / (2 * p["mdot_a"] * torch.clamp(I_d * p["V_d"], min=1e-6)),
        "ui": avg["ui"],
        "z": torch.broadcast_to(z, (nB, cfg.nc)),
        "Tev": avg["Te"],
        "ne": avg["ne"],
        "nn": avg["nn"],
        "potential": phi,
        "E": E_avg,
        "nu_anom": nu_anom,
        "B": B,
    }


def _init_batch(params: dict, base_B, cfg: SolverConfig):
    """The carry at step 0."""
    return make_step(params, base_B, cfg)[1]


#: steps of the CUDA graph the lax loop replays on a CUDA device
GRAPH_STEPS = 100


def _traced(step, cfg: SolverConfig):
    """``advance(carry, trace) -> carry'``: one step; with a ``trace`` of
    ``cfg.num_save + 1`` columns also the step's discharge current written to
    column ``i // stride`` when ``i % stride == 0`` and ``i // stride <
    num_save``, and to the spare last column otherwise (JAX's ``step_save``;
    ``stride = max(1, num_steps // num_save)``)."""
    stride = max(1, cfg.num_steps // max(cfg.num_save, 1))

    def advance(carry, trace=None):
        i = carry[2]
        carry, I_d = step(carry)
        if trace is not None:
            k = i // stride
            col = torch.where((i % stride == 0) & (k < cfg.num_save), k, cfg.num_save)
            trace.index_copy_(1, col.reshape(1), I_d[:, None])
        return carry

    return advance


def _loop(advance, carry, n_steps: int, trace=None):
    for _ in range(n_steps):
        carry = advance(carry, trace)
    return carry


def _leaves(carry) -> list:
    state, accum, i, failed = carry
    return list(state) + [accum[k] for k in ACCUM_KEYS] + [i, failed]


def _clone(carry):
    state, accum, i, failed = carry
    return tuple(x.clone() for x in state), {k: v.clone() for k, v in accum.items()}, i.clone(), failed.clone()


class _Replay:
    """The lax step loop on a CUDA device as captured CUDA graphs.

    ``carry`` is copied into static buffers; a graph of ``n`` steps runs the
    steps from them and copies the result back into them, and ``trace`` (if any)
    is written in place. :meth:`advance` replays a graph of ``min(GRAPH_STEPS,
    n_steps)`` steps, then a graph of the remainder: exactly ``n_steps`` steps,
    never more (one more step can flip a row's failure flag). Each graph is
    captured once by :func:`..cuda_graph.capture`, after one step on throwaway
    copies; a capture or replay error is raised."""

    def __init__(self, advance, carry, trace=None):
        self._advance, self._trace = advance, trace
        self.carry = _clone(carry)
        self._graphs: dict = {}

    def graph(self, n_steps: int):
        """The graph of ``n_steps`` steps, captured on first use."""
        if n_steps not in self._graphs:
            def warmup():
                _loop(self._advance, _clone(self.carry), 1, None if self._trace is None else self._trace.clone())

            def body():
                out = _loop(self._advance, self.carry, n_steps, self._trace)
                for dst, src in zip(_leaves(self.carry), _leaves(out)):
                    dst.copy_(src)

            self._graphs[n_steps] = cuda_graph.capture(body, self.carry[3].device, warmup)
        return self._graphs[n_steps]

    def advance(self, n_steps: int) -> None:
        if n_steps <= 0:
            return
        size = min(GRAPH_STEPS, n_steps)
        full, tail = divmod(n_steps, size)
        for _ in range(full):
            self.graph(size).replay()
        if tail:
            self.graph(tail).replay()


class _Eager:
    """The lax step loop one operator at a time, with :class:`_Replay`'s interface."""

    def __init__(self, advance, carry, trace=None):
        self._advance, self._trace, self.carry = advance, trace, carry

    def advance(self, n_steps: int) -> None:
        self.carry = _loop(self._advance, self.carry, n_steps, self._trace)


def stepper(params: dict, base_B, carry, cfg: SolverConfig, trace=None):
    """The lax loop from ``carry``: ``.advance(n_steps)``, then ``.carry``.
    On a CUDA device it replays captured CUDA graphs (:class:`_Replay`; a
    caller that advances by the same count again reuses the graph), on the CPU
    it steps eagerly. ``trace`` as in :func:`_segment_batch`."""
    advance = _traced(make_step(params, base_B, cfg)[0], cfg)
    return (_Replay if carry[3].device.type == "cuda" else _Eager)(advance, carry, trace)


def _segment_batch(params: dict, base_B, carry, cfg: SolverConfig, n_steps: int, trace=None):
    """``n_steps`` steps from ``carry``: replayed CUDA graphs (:class:`_Replay`)
    on a CUDA device, one step at a time on the CPU. With ``trace``
    (B, num_save + 1), the discharge current of every step ``i`` with
    ``i % stride == 0`` is written to column ``i // stride`` (``stride =
    max(1, num_steps // num_save)``), the other steps' to the last column."""
    run = stepper(params, base_B, carry, cfg, trace)
    run.advance(n_steps)
    return run.carry


def _segment_batch_eager(params: dict, base_B, carry, cfg: SolverConfig, n_steps: int, trace=None):
    """:func:`_segment_batch` one step at a time on any device: the operators
    the graphs hold, in the same order, for comparing the two on the card."""
    run = _Eager(_traced(make_step(params, base_B, cfg)[0], cfg), carry, trace)
    run.advance(n_steps)
    return run.carry


def _finalize_batch(params: dict, carry, base_B, cfg: SolverConfig) -> dict:
    """The time-averaged outputs of a carry."""
    p, z, B, _, nu_anom = _static_profiles(params, base_B, cfg)
    _, accum, _, failed = carry
    return _finalize(p, accum, failed, z, nu_anom, B, cfg)


def simulate_batch(params: dict, base_B: torch.Tensor, cfg: SolverConfig) -> dict:
    """Run the discharge for a batch of parameter sets on their device.

    :param params: dict of (batch,) tensors (``config.make_params``)
    :param base_B: (NC,) unscaled magnetic-field profile on the cell centres [T]
    :returns: dict of (batch, ...) time averages in the config's dtype; with
        ``cfg.num_save > 0`` also ``discharge_current_trace`` (batch, num_save),
        NaN rows for failed samples, and its ``trace_times``
    """
    carry = _init_batch(params, base_B, cfg)
    trace = None
    if cfg.num_save > 0:
        trace = torch.zeros((params["V_d"].shape[0], cfg.num_save + 1), dtype=_dtype(cfg),
                            device=params["V_d"].device)
    carry = _segment_batch(params, base_B, carry, cfg, cfg.num_steps, trace)
    out = _finalize_batch(params, carry, base_B, cfg)
    if trace is not None:
        stride = max(1, cfg.num_steps // cfg.num_save)
        failed = carry[3]
        trace = trace[:, :cfg.num_save]
        idx = torch.arange(cfg.num_save, device=trace.device) * stride
        out["discharge_current_trace"] = torch.where(failed[:, None], torch.nan, trace)
        out["trace_times"] = torch.broadcast_to((idx.to(torch.float32) + 1.0) * cfg.dt, trace.shape)
    return out


def simulate_batch_chunked(params: dict, base_B: torch.Tensor, cfg: SolverConfig,
                           chunk_steps: int = 2000) -> dict:
    """:func:`simulate_batch` with the time loop split into ``chunk_steps``-step
    segments (the same numbers; no discharge-current trace)."""
    carry = _init_batch(params, base_B, cfg)
    for _ in range(-(-cfg.num_steps // chunk_steps)):
        carry = _segment_batch(params, base_B, carry, cfg, chunk_steps)
    return _finalize_batch(params, carry, base_B, cfg)


def carry_from_jax_numpy(carry, device) -> tuple:
    """The JAX package's batched lax carry (``_init_batch`` / ``_segment_batch``),
    as numpy arrays, to the port's carry on ``device``. The step index must be
    the same for every sample; it becomes a 0-d int64 tensor."""
    (rho_n, rho_i, mom_i, nE, I_prev), accum, i, failed = carry
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    steps = np.unique(np.asarray(i))
    if steps.size != 1:
        raise ValueError(f"the samples of a carry are at different steps: {steps}")
    return ((t(rho_n), t(rho_i), t(mom_i), t(nE), t(I_prev)), {k: t(accum[k]) for k in ACCUM_KEYS},
            torch.tensor(int(steps[0]), dtype=torch.int64, device=device), t(failed))
