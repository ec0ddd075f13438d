"""K-step discharge solver on the padded (B, LN) lane layout: the plain PyTorch
version of the hand-written CUDA kernel, and the time loop around both.

Counterpart of the JAX package's ``models/thruster/pallas_step.py``
(``make_physics``, ``sanitize_state``, ``build_multistep_kernel``,
``build_step_kernel``, ``simulate_batch_pallas_multi``, ``_pack_consts``,
``_initial_state``, ``_pallas_finalize``). Each sample's cells sit on lanes 0..NC-1 of a row of
LN = 128 (NC <= 126) or 256 lanes; lanes past NC-1 are padding. Neighbour reads
are circular rolls over all LN lanes: the mask-free cyclic reduction in the
electron-energy solve relies on a wrapped read meeting an exact 0 in the
padding rows, so a clamped or masked read would change the numbers.

Packed tensors (float32, contiguous), shared by the plain version and the kernel:

- ``state`` (2 + 2Z + G - 1, B, LN): rho_n, nE, then (rho_i, mom_i) for each charge
  state, then, with two neutral groups (G = 2), the fast group's density rho_n2;
- ``prof`` (Z + 4, B, LN): running sums of u_i per charge state, Te, ne, E, nn;
- ``sacc`` (B, 128): scalar accumulators (slots ``A_*``), the circuit current and,
  when ``cfg.num_save > 0``, the I_d(t) trace lanes ``A_TRACE0 + k``;
- ``consts``: ``nu_anom`` and ``omega_ce`` (B, LN), ``scalars`` (B, 128) (slots ``P_*``);
- ``extras`` (5, B, LN), written by the one-step kernel: j_d, qs_t, qs_f in lanes
  0, 1, 2 of the first array, then Te, ne, E, nn.

Every arithmetic expression keeps the operand order of the JAX model, so that
float32 rounding matches it as closely as eager PyTorch allows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hallthrusterpem_tpu_torch.constants import ELECTRON_MASS, FUNDAMENTAL_CHARGE
from hallthrusterpem_tpu_torch.models.thruster.config import (
    SolverConfig,
    background_neutral_ingestion_flux,
)
from hallthrusterpem_tpu_torch.models.thruster.rates import (
    K_EN,
    build_reactions,
    dlnk_dlnTe_poly,
    excitation_log_poly,
)
from hallthrusterpem_tpu_torch.models.thruster.solver import (
    anomalous_profile,
    wall_energy_loss_rate,
)

_E = FUNDAMENTAL_CHARGE
_ME = ELECTRON_MASS
LANES = 256  # widest lane layout (nc <= 254)

# per-sample scalar slots of consts["scalars"]; P_ICIR is the circuit current of
# the one-step kernel, rewritten by its driver before every step
P_DV, P_MDOT, P_UN, P_CW, P_TECATH, P_TANDIV, P_RC, P_LDT, P_ICIR = range(9)
# accumulator slots of sacc; A_ICIR carries the circuit current across launches
A_THRUST, A_ID, A_ID2, A_IB0, A_MDOT, A_UEXIT, A_FAILED, A_ICIR = range(8)
#: first I_d(t) trace lane of sacc (set at every step of a launch when tracing)
A_TRACE0 = 8
N_SLOTS = 128
#: most steps a tracing launch may take: one trace lane per step
MAX_TRACE_STEPS = N_SLOTS - A_TRACE0
#: timesteps per kernel launch on the main path (the TPU kernel's default K)
INNER_STEPS = 50


def lanes_for(cfg: SolverConfig) -> int:
    """Lane width of the layout: 128 lanes for nc <= 126, else 256."""
    return 128 if cfg.nc <= 126 else LANES


def check_supported(cfg: SolverConfig) -> None:
    """Raise for the configurations the lane-layout solver does not run."""
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: the lane-layout solver runs in float32 only; other "
            "precisions run on the lax solver, solver.simulate_batch")
    if cfg.nc > LANES - 2:
        raise NotImplementedError(
            f"num_cells={cfg.num_cells} exceeds the {LANES}-lane kernel layout; grids this "
            "fine run on the lax solver, solver.simulate_batch")
    if not 1 <= cfg.ncharge <= 3:
        raise ValueError(f"ncharge={cfg.ncharge}: the solver supports 1 to 3 charge states")
    if cfg.neutral_groups not in (1, 2):
        raise ValueError(f"neutral_groups={cfg.neutral_groups}: the solver supports 1 or 2")


def n_state_for(cfg: SolverConfig) -> int:
    """rho_n, nE, (rho_i, mom_i) per charge state, then rho_n2 for two groups."""
    return 2 + 2 * cfg.ncharge + (cfg.neutral_groups - 1)


def rate_polys(cfg: SolverConfig):
    """Log-poly rate fits in kernel order: [(coeffs, dcoeffs, z_from, z_to, energy)]
    for each ionization reaction, then (coeffs, dcoeffs, energy) of excitation."""
    return _rate_polys(cfg.propellant, cfg.ncharge)


@functools.lru_cache(maxsize=None)
def _rate_polys(propellant: str, ncharge: int):
    # the fits take ~0.2 s and depend on nothing else: a config whose dt changes
    # with every batch (adaptive stepping) must not pay for them on every call
    rxn = tuple((np.asarray(r.log_poly), dlnk_dlnTe_poly(r.log_poly), r.z_from, r.z_to, r.energy_eV)
                for r in build_reactions(propellant, ncharge))
    ex, ex_energy = excitation_log_poly(propellant)
    return rxn, (ex, dlnk_dlnTe_poly(ex), ex_energy)


def _poly_eval(coeffs, x):
    out = float(coeffs[0]) * x + float(coeffs[1])
    for c in coeffs[2:]:
        out = out * x + float(c)
    return out


def _roll(x, shift: int):
    """out[:, i] = x[:, i - shift], circular over all lanes."""
    return torch.roll(x, shift, dims=1)


def sanitize_state(cfg: SolverConfig, rho_n, nE, rho_i, mom_i, rho_n2=None):
    """NaN/range scrub of the heavy-species and energy state (``rho_n2``, the
    fast neutral group, is scrubbed like ``rho_n`` when given)."""
    mi = cfg.mi
    rho_floor = float(1e10 * mi)
    sane = lambda x, lo, hi: torch.clamp(torch.where(torch.isfinite(x), x, lo), lo, hi)
    rho_n = sane(rho_n, rho_floor, 1e21 * mi)
    rho_i = [sane(r, rho_floor, 1e21 * mi) for r in rho_i]
    mom_i = [torch.clamp(torch.where(torch.isfinite(m), m, 0.0), -r * 3e5, r * 3e5)
             for m, r in zip(mom_i, rho_i)]
    nE = sane(nE, 1.0, 1e23)
    if rho_n2 is not None:
        rho_n2 = sane(rho_n2, rho_floor, 1e21 * mi)
    return rho_n, nE, rho_i, mom_i, rho_n2


def unpack_scrubbed(cfg: SolverConfig, state):
    """Views of the packed state, scrubbed: ``(rho_n, nE, rho_i, mom_i, rho_n2, u_i)``
    with ``u_i`` the ion velocities of the scrubbed state (``rho_n2`` is None for
    one neutral group)."""
    Z = cfg.ncharge
    rho_floor = float(1e10 * cfg.mi)
    rho_n, nE, rho_i, mom_i, rho_n2 = sanitize_state(
        cfg, state[0], state[1], [state[2 + 2 * z] for z in range(Z)],
        [state[3 + 2 * z] for z in range(Z)], state[2 + 2 * Z] if cfg.neutral_groups == 2 else None)
    u_i = [m / torch.clamp(r, min=rho_floor) for m, r in zip(mom_i, rho_i)]
    return rho_n, nE, rho_i, mom_i, rho_n2, u_i


def store_state(state, rho_n, nE, rho_i, mom_i, rho_n2) -> None:
    """Write a state back into the packed layout."""
    Z = len(rho_i)
    state[0] = rho_n
    state[1] = nE
    for z in range(Z):
        state[2 + 2 * z] = rho_i[z]
        state[3 + 2 * z] = mom_i[z]
    if rho_n2 is not None:
        state[2 + 2 * Z] = rho_n2


class Physics:
    """One timestep of the discharge on (B, LN) tensors, for one config
    (the plain version of the CUDA kernel's step body)."""

    def __init__(self, cfg: SolverConfig):
        check_supported(cfg)
        self.cfg = cfg
        self.NC = cfg.nc
        self.LN = lanes_for(cfg)
        self.Z = cfg.ncharge
        self.G = cfg.neutral_groups
        self.rxn, self.ex = rate_polys(cfg)

    def loop_invariants(self, c_w, tan_div):
        """Lane masks, geometry, the static plume cone and the wall
        collisionality: everything that does not change over the K steps."""
        cfg, NC = self.cfg, self.NC
        B = c_w.shape[0]
        dz = cfg.dz
        inv_dz = 1.0 / dz
        lane = torch.arange(self.LN, device=c_w.device).expand(B, self.LN)
        interior = (lane >= 1) & (lane <= NC - 2)
        in_domain = lane <= NC - 1
        interior_f = interior.float()
        face_f = (lane <= NC - 2).float()
        z_cell = torch.where(lane == 0, 0.0, (lane.float() - 0.5) * dz)
        z_cell = torch.where(lane >= NC - 1, cfg.domain[1] - cfg.domain[0], z_cell)
        in_channel = (z_cell <= cfg.geometry.channel_length).float()
        nu_ew = (cfg.electron_wall_losses * cfg.wall_momentum_scale * 1e7) * c_w * in_channel
        pre = dict(lane=lane, interior=interior, in_domain=in_domain, interior_f=interior_f,
                   face_f=face_f, z_cell=z_cell, in_channel=in_channel, nu_ew=nu_ew)
        if cfg.solve_plume:
            g = cfg.geometry
            tand = torch.clamp(tan_div, 0.0, 2.0)
            drz = tand * torch.clamp(z_cell - g.channel_length, min=0.0)
            r_o = g.outer_radius + drz
            r_i_pl = torch.clamp(g.inner_radius - drz, min=0.0)
            AR = (r_o * r_o - r_i_pl * r_i_pl) * (1.0 / (g.outer_radius**2 - g.inner_radius**2))
            inv_AR = 1.0 / AR
            AR_f = 0.5 * (AR + _roll(AR, -1))
            ARf_m = _roll(AR_f, 1)
            dlnA = (AR_f - ARf_m) * inv_dz * inv_AR * interior_f
            ar_ex = AR[:, NC - 2][:, None]
            qs_t = ar_ex * torch.rsqrt(1.0 + tand * tand) \
                if cfg.apply_thrust_divergence_correction else ar_ex
            pre.update(AR=AR, inv_AR=inv_AR, AR_f=AR_f, ARf_m=ARf_m, dlnA=dlnA,
                       wp=AR_f * inv_AR, wm=ARf_m * inv_AR, qs_t=qs_t, qs_f=ar_ex)
        return pre

    def __call__(self, rho_n, nE, rho_i, mom_i, u_i, nu_anom, omega_ce, dV, mdot_in, u_n,
                 c_w, te_cath, rc, l_dt, i_prev, pre, rho_n2=None):
        """Advance one step from a scrubbed state. ``u_i`` are the ion velocities
        of the state (carried from the previous step); ``rho_n2`` is the fast
        neutral group (two groups only). Per-sample scalars are (B, 1). Returns
        ``(rho_n', nE', rho_i', mom_i', rho_n2'), (j_d, Te, ne, E_z, nn)``."""
        cfg, NC, Z, G = self.cfg, self.NC, self.Z, self.G
        dz, dt, mi = cfg.dz, cfg.dt, cfg.mi
        A_ch = cfg.geometry.channel_area
        gap = cfg.geometry.channel_gap
        a_i = float(np.sqrt(1.380649e-23 * cfg.ion_temp_K / mi))
        zq = [float(z) for z in range(1, Z + 1)]
        k_en = K_EN.get(cfg.propellant, 2.5e-13)
        rho_floor = float(1e10 * mi)
        inv_mi, inv_dz, inv_dt = 1.0 / mi, 1.0 / dz, 1.0 / dt
        lane, interior, in_domain = pre["lane"], pre["interior"], pre["in_domain"]
        interior_f, face_f, in_channel = pre["interior_f"], pre["face_f"], pre["in_channel"]

        # ---- plasma properties
        ni = [r * inv_mi for r in rho_i]
        ne = ni[0] * zq[0]
        for z in range(1, Z):
            ne = ne + zq[z] * ni[z]
        ne = torch.clamp(ne, min=cfg.ne_floor)
        inv_ne = 1.0 / ne
        Te = torch.clamp((2.0 / 3.0) * nE * inv_ne, cfg.Te_min, cfg.Te_max)
        if G == 2:
            # neutral velocity-space quadrature: group speeds are fixed ratios of
            # u_n, ionization consumption is split by density share, and the
            # momentum-source speed is share-weighted
            nn_g0 = rho_n * inv_mi
            nn_g1 = rho_n2 * inv_mi
            nn = torch.clamp(nn_g0 + nn_g1, min=1e6)
            inv_nn = 1.0 / nn
            share0 = nn_g0 * inv_nn
            share1 = nn_g1 * inv_nn
            u_g0 = cfg.slow_neutral_ratio * u_n
            u_g1 = cfg.fast_neutral_ratio * u_n
            u_n_src = share0 * u_g0 + share1 * u_g1
        else:
            nn = torch.clamp(rho_n * inv_mi, min=1e6)
            u_n_src = u_n

        # ---- collisions & mobility
        lnTe = torch.log(Te)
        lnL = torch.clamp(23.0 - 0.5 * torch.log(ne * 1e-6) + 1.5 * lnTe, 2.0, 30.0)
        rs_te = torch.rsqrt(Te)
        nu_ei = 2.9e-12 * ne * lnL * (rs_te * rs_te * rs_te)
        nu_e = k_en * nn + nu_ei + nu_anom + pre["nu_ew"]
        mu = (_E / _ME) * nu_e / (nu_e * nu_e + omega_ce * omega_ce)
        inv_AR = pre["inv_AR"] if cfg.solve_plume else 1.0

        # ---- Ohm's law: two lane reductions and the RL circuit filter
        j_i = zq[0] * ni[0] * u_i[0]
        for z in range(1, Z):
            j_i = j_i + zq[z] * ni[z] * u_i[z]
        j_i = _E * j_i
        pe = ne * Te
        grad_pe = (_roll(pe, -1) - _roll(pe, 1)) * (0.5 * inv_dz)
        grad_pe = torch.where(lane == 0, (_roll(pe, -1) - pe) * inv_dz, grad_pe)
        grad_pe = torch.where(lane == NC - 1, (pe - _roll(pe, 1)) * inv_dz, grad_pe)
        grad_pe = torch.where(in_domain, grad_pe, 0.0)
        inv_enmu = 1.0 / (_E * ne * mu)
        gpe_ne = grad_pe * inv_ne
        num_igd = (j_i * inv_enmu + gpe_ne) * interior_f
        den_igd = (inv_AR * inv_enmu * interior_f) if cfg.solve_plume else (inv_enmu * interior_f)
        num_int = torch.sum(num_igd, dim=1, keepdim=True) * dz
        i_prev = torch.clamp(i_prev, -1e4, 1e4)
        den_pl = torch.sum(den_igd, dim=1, keepdim=True) * dz + rc * A_ch
        den_all = den_pl + l_dt * A_ch
        j_prev = i_prev * (1.0 / A_ch)
        j_d = j_prev + (dV + num_int - j_prev * den_pl) / den_all
        if cfg.anode_sheath:
            ne1, Te1, j_i1 = ne[:, 1:2], Te[:, 1:2], j_i[:, 1:2]
            j_e_th = _E * ne1 * torch.sqrt(_E * Te1 / (2.0 * np.pi * _ME))
            j_e_req = torch.maximum(j_d - j_i1, 1e-6 * j_e_th)
            phi_s = torch.clamp(Te1 * torch.log(j_e_th / j_e_req),
                                min=torch.zeros_like(dV), max=0.5 * torch.abs(dV))
            j_d = j_prev + (dV - phi_s + num_int - j_prev * den_pl) / den_all
        j_d_loc = j_d * inv_AR if cfg.solve_plume else j_d
        E_z = (j_d_loc - j_i) * inv_enmu - gpe_ne

        # ---- heavy-species ghost cells
        u_bohm1 = torch.sqrt(_E * Te[:, 1:2] / mi)
        mom_back = torch.zeros_like(dV)
        for z in range(Z):
            mom_back = mom_back + torch.clamp(mom_i[z][:, 1:2], max=0.0)
        if G == 2:
            # injected flux split over the groups; anode-recycled ion backflow
            # re-enters the slow group
            fr = cfg.fast_neutral_fraction
            rho_n_l = ((1.0 - fr) * (mdot_in / A_ch) - mom_back) / u_g0
            rho_n2_l = (fr * (mdot_in / A_ch)) / u_g1
            rho_n2_b = torch.where(lane == 0, rho_n2_l, rho_n2)
            rho_n2_b = torch.where(lane == NC - 1, _roll(rho_n2, 1), rho_n2_b)
        else:
            rho_n_l = (mdot_in / A_ch - mom_back) / u_n
        rho_n_b = torch.where(lane == 0, rho_n_l, rho_n)
        rho_n_b = torch.where(lane == NC - 1, _roll(rho_n, 1), rho_n_b)
        rho_b, mom_b = [], []
        bohm_c = [float(np.float32(-cfg.mdot_bohm_fraction) * np.sqrt(np.float32(z_), dtype=np.float32))
                  for z_ in zq]
        for z in range(Z):
            u_gl = torch.minimum(u_i[z][:, 1:2], bohm_c[z] * u_bohm1)
            r_gl = rho_i[z][:, 1:2]
            rb = torch.where(lane == 0, r_gl, rho_i[z])
            rb = torch.where(lane == NC - 1, _roll(rho_i[z], 1), rb)
            mb = torch.where(lane == 0, r_gl * u_gl, mom_i[z])
            mb = torch.where(lane == NC - 1, _roll(mom_i[z], 1), mb)
            rho_b.append(rb)
            mom_b.append(mb)

        # ---- fluxes through face i (between cells i and i+1): MUSCL minmod + HLLE
        def minmod_slope(q):
            if not cfg.reconstruct:
                return torch.zeros_like(q)
            dq_p = _roll(q, -1) - q
            dq_m = _roll(dq_p, 1)
            s = 0.5 * (torch.sign(dq_m) + torch.sign(dq_p)) * torch.minimum(
                torch.abs(dq_m), torch.abs(dq_p))
            return s * interior_f

        sl_rn = minmod_slope(rho_n_b)
        if G == 2:
            Fn = u_g0 * torch.clamp(rho_n_b + 0.5 * sl_rn, min=rho_floor) * face_f
            sl_rn2 = minmod_slope(rho_n2_b)
            Fn2 = u_g1 * torch.clamp(rho_n2_b + 0.5 * sl_rn2, min=rho_floor) * face_f
        else:
            Fn = u_n * torch.clamp(rho_n_b + 0.5 * sl_rn, min=rho_floor) * face_f
        Fr, Fm = [], []
        for z in range(Z):
            u_b = mom_b[z] / torch.clamp(rho_b[z], min=rho_floor)
            sl_r = minmod_slope(rho_b[z])
            sl_u = minmod_slope(u_b)
            rL = torch.clamp(rho_b[z] + 0.5 * sl_r, min=rho_floor)
            rR = torch.clamp(_roll(rho_b[z] - 0.5 * sl_r, -1), min=rho_floor)
            uL = u_b + 0.5 * sl_u
            uR = _roll(u_b - 0.5 * sl_u, -1)
            mL, mR = rL * uL, rR * uR
            sL = torch.clamp(torch.minimum(uL - a_i, uR - a_i), max=0.0)
            sR = torch.clamp(torch.maximum(uL + a_i, uR + a_i), min=0.0)
            ds = torch.clamp(sR - sL, min=1e-8)
            FmL = mL * uL + rL * (a_i * a_i)
            FmR = mR * uR + rR * (a_i * a_i)
            inv_ds = face_f / ds
            Fr.append((sR * mL - sL * mR + sL * sR * (rR - rL)) * inv_ds)
            Fm.append((sR * FmL - sL * FmR + sL * sR * (mR - mL)) * inv_ds)

        if cfg.solve_plume:
            AR_f = pre["AR_f"]
            ddz = lambda F: ((F * AR_f) - _roll(F * AR_f, 1)) * inv_dz * inv_AR
        else:
            ddz = lambda F: (F - _roll(F, 1)) * inv_dz

        # ---- sources: log-poly rates, E-force, pressure-area, ion-wall losses
        d_rho_n = torch.zeros_like(rho_n)
        d_rho_n2 = torch.zeros_like(rho_n) if G == 2 else None
        d_rho = [torch.zeros_like(rho_n) for _ in range(Z)]
        d_mom = [torch.zeros_like(rho_n) for _ in range(Z)]
        inelastic = torch.zeros_like(rho_n)
        dinel_dTe = torch.zeros_like(rho_n)
        inv_Te = 1.0 / Te
        for coeffs, dcoeffs, z_from, z_to, energy in self.rxn:
            k_r = torch.exp(_poly_eval(coeffs, lnTe))
            n_from = nn if z_from == 0 else ni[z_from - 1]
            u_from = u_n_src if z_from == 0 else u_i[z_from - 1]
            dm = (ne * k_r) * n_from * mi
            if z_from == 0 and G == 2:
                d_rho_n = d_rho_n - dm * share0
                d_rho_n2 = d_rho_n2 - dm * share1
            elif z_from == 0:
                d_rho_n = d_rho_n - dm
            else:
                d_rho[z_from - 1] = d_rho[z_from - 1] - dm
                d_mom[z_from - 1] = d_mom[z_from - 1] - dm * u_from
            d_rho[z_to - 1] = d_rho[z_to - 1] + dm
            d_mom[z_to - 1] = d_mom[z_to - 1] + dm * u_from
            contrib = dm * (energy * inv_mi)
            inelastic = inelastic + contrib
            if cfg.implicit_inelastic:
                dinel_dTe = dinel_dTe + contrib * _poly_eval(dcoeffs, lnTe) * inv_Te
        ex_coeffs, ex_dcoeffs, ex_energy = self.ex
        k_ex = torch.exp(_poly_eval(ex_coeffs, lnTe))
        ex_contrib = (ne * k_ex) * nn * ex_energy
        inelastic = inelastic + ex_contrib
        if cfg.implicit_inelastic:
            dinel_dTe = dinel_dTe + ex_contrib * _poly_eval(ex_dcoeffs, lnTe) * inv_Te
            dinel_dTe = torch.clamp(dinel_dTe, min=0.0)

        for z in range(Z):
            d_mom[z] = d_mom[z] + zq[z] * _E * ni[z] * E_z
        if cfg.solve_plume:
            for z in range(Z):
                d_mom[z] = d_mom[z] + rho_i[z] * (a_i * a_i) * pre["dlnA"]
        if cfg.ion_wall_losses:
            sqrt_te = torch.sqrt(_E * Te / mi)
            for z in range(Z):
                nu_iw = float(0.6 * np.sqrt(zq[z]) / gap) * sqrt_te * in_channel
                d_rho[z] = d_rho[z] - nu_iw * rho_i[z]
                d_mom[z] = d_mom[z] - nu_iw * mom_i[z]
                d_rho_n = d_rho_n + cfg.wall_recycling * (nu_iw * rho_i[z])

        upd = lambda base, flux, src: base + (-dt) * ddz(flux) * interior_f + dt * src * interior_f
        rho_n_new = torch.clamp(upd(rho_n_b, Fn, d_rho_n), min=rho_floor)
        rho_n2_new = torch.clamp(upd(rho_n2_b, Fn2, d_rho_n2), min=rho_floor) if G == 2 else None
        rho_new = [torch.clamp(upd(rho_b[z], Fr[z], d_rho[z]), min=rho_floor) for z in range(Z)]
        mom_new = [upd(mom_b[z], Fm[z], d_mom[z]) for z in range(Z)]

        # ---- electron energy: backward Euler in Te, row-normalised PCR over lanes
        ne_new = rho_new[0] * (inv_mi * zq[0])
        for z in range(1, Z):
            ne_new = ne_new + rho_new[z] * (zq[z] * inv_mi)
        ne_new = torch.clamp(ne_new, min=cfg.ne_floor)

        Gamma_e = (j_i - j_d_loc) * (1.0 / _E)
        G_f = 0.5 * (Gamma_e + _roll(Gamma_e, -1))
        kap = (10.0 / 9.0) * mu * ne * Te
        kf = (0.5 * inv_dz) * (kap + _roll(kap, -1))
        Gp = 2.5 * torch.clamp(G_f, min=0.0)
        Gn = 2.5 * torch.clamp(G_f, max=0.0)
        nu_eps = cfg.electron_wall_losses * wall_energy_loss_rate(
            Te, ne, in_channel, c_w, cfg, lnTe=lnTe, rs_te=rs_te)
        q_ohm = (j_d_loc - j_i) * E_z * (1.0 / _E)

        Gp_m, Gn_m, kf_m = _roll(Gp, 1), _roll(Gn, 1), _roll(kf, 1)
        if cfg.solve_plume:
            wp, wm = pre["wp"], pre["wm"]
            sub = (-Gp_m - kf_m) * wm * inv_dz
            sup = (Gn - kf) * wp * inv_dz
            diag = ne_new * (1.5 * inv_dt + nu_eps * 1.5) + (
                (Gp + kf) * wp + (kf_m - Gn_m) * wm) * inv_dz
        else:
            sub = (-Gp_m - kf_m) * inv_dz
            sup = (Gn - kf) * inv_dz
            diag = ne_new * (1.5 * inv_dt + nu_eps * 1.5) + (Gp - Gn_m + kf + kf_m) * inv_dz
        rhs = nE * inv_dt + q_ohm - inelastic
        if cfg.implicit_inelastic:
            diag = diag + dinel_dTe
            rhs = rhs + dinel_dTe * Te
        # Dirichlet boundary values folded into the first and last interior rows
        Te_bc_l = torch.full_like(dV, cfg.anode_Te)
        rhs = torch.where(lane == 1, rhs - sub * Te_bc_l, rhs)
        rhs = torch.where(lane == NC - 2, rhs - sup * te_cath, rhs)
        sub = torch.where(lane == 1, 0.0, sub)
        sup = torch.where(lane == NC - 2, 0.0, sup)
        sub = torch.where(interior, sub, 0.0)
        sup = torch.where(interior, sup, 0.0)
        diag = torch.where(interior, diag, 1.0)
        rhs = torch.where(interior, rhs, 1.0)

        inv = 1.0 / diag
        a, c, d = sub * inv, sup * inv, rhs * inv
        k = 1
        n_levels = max(1, int(np.ceil(np.log2(max(NC, 2)))))
        for lvl in range(n_levels):
            cm, ap = _roll(c, k), _roll(a, -k)
            dm_, dp_ = _roll(d, k), _roll(d, -k)
            b_new = 1.0 - a * cm - c * ap
            d = d - a * dm_ - c * dp_
            rb = 1.0 / b_new
            d = d * rb
            if lvl < n_levels - 1:
                a = -a * _roll(a, k) * rb
                c = -c * _roll(c, -k) * rb
            k *= 2
        Te_new = torch.where(lane == 0, Te_bc_l, d)
        Te_new = torch.where(lane >= NC - 1, te_cath, Te_new)
        Te_new = torch.clamp(Te_new, cfg.Te_min, cfg.Te_max)
        nE_new = 1.5 * ne_new * Te_new
        return (rho_n_new, nE_new, rho_new, mom_new, rho_n2_new), (j_d, Te, ne, E_z, nn)


def kstep_plain(state, prof, sacc, consts, i0: int, K: int, cfg: SolverConfig,
                physics: Physics | None = None) -> None:
    """Steps ``i0 .. i0+K-1`` of the discharge, in place on ``state``, ``prof`` and
    ``sacc``: the plain PyTorch version of the CUDA kernel (one launch of it).

    The state is scrubbed once on entry, with a was-nonfinite flag OR-ed into the
    failed slot; each step's accumulation is gated by
    ``avg_start_step <= i < num_steps`` so that the overshoot steps of the last
    block do not count. With ``cfg.num_save > 0`` step k also sets trace lane
    ``A_TRACE0 + k`` of ``sacc`` to its discharge current (K <= 120)."""
    physics = physics or Physics(cfg)
    trace = cfg.num_save > 0
    if trace and K > MAX_TRACE_STEPS:
        raise ValueError(f"kstep: K={K} exceeds the {MAX_TRACE_STEPS} trace lanes")
    Z, NC = cfg.ncharge, cfg.nc
    mi = cfg.mi
    A_ch = cfg.geometry.channel_area
    a_i2 = 1.380649e-23 * cfg.ion_temp_K / mi
    rho_floor = float(1e10 * mi)
    exit_ix = NC - 2
    scal = consts["scalars"]
    col = lambda s: scal[:, s : s + 1]
    dV, mdot_in, u_n, c_w, te_cath, tan_div, rc, l_dt = (col(s) for s in range(8))
    nu_anom, omega = consts["nu_anom"], consts["omega_ce"]
    pre = physics.loop_invariants(c_w, tan_div)

    bad = (~torch.isfinite(state)).any(dim=2).any(dim=0).float()
    sacc[:, A_FAILED] = torch.maximum(sacc[:, A_FAILED], bad)
    rho_n, nE, rho_i, mom_i, rho_n2, u_i = unpack_scrubbed(cfg, state)
    icir = sacc[:, A_ICIR : A_ICIR + 1]
    for k in range(K):
        (rho_n, nE, rho_i, mom_i, rho_n2), (j_d, Te, ne, E_z, nn) = physics(
            rho_n, nE, rho_i, mom_i, u_i, nu_anom, omega, dV, mdot_in, u_n, c_w, te_cath,
            rc, l_dt, icir, pre, rho_n2)
        u_i = [mom_i[z] / torch.clamp(rho_i[z], min=rho_floor) for z in range(Z)]
        i = i0 + k
        w = float(cfg.avg_start_step <= i < cfg.num_steps)

        thrust = I_B0 = mdot_ion = 0.0
        for z in range(Z):
            r_ex, m_ex, u_ex = rho_i[z][:, exit_ix], mom_i[z][:, exit_ix], u_i[z][:, exit_ix]
            thrust = thrust + A_ch * (m_ex * u_ex + r_ex * a_i2)
            I_B0 = I_B0 + (A_ch * _E * (z + 1) / mi) * r_ex * u_ex
            mdot_ion = mdot_ion + A_ch * m_ex
            prof[z] += w * u_i[z]
        if cfg.solve_plume:
            thrust = thrust * pre["qs_t"][:, 0]
            I_B0 = I_B0 * pre["qs_f"][:, 0]
            mdot_ion = mdot_ion * pre["qs_f"][:, 0]
        I_d = j_d[:, 0] * A_ch
        for off, val in enumerate((Te, ne, E_z, nn)):
            prof[Z + off] += w * val
        sacc[:, A_THRUST] += w * thrust
        sacc[:, A_ID] += w * I_d
        sacc[:, A_ID2] += w * I_d * I_d
        sacc[:, A_IB0] += w * I_B0
        sacc[:, A_MDOT] += w * mdot_ion
        sacc[:, A_UEXIT] += w * u_i[0][:, exit_ix]
        sacc[:, A_FAILED] = torch.maximum(sacc[:, A_FAILED], (~torch.isfinite(I_d)).float())
        sacc[:, A_ICIR] = I_d
        if trace:
            sacc[:, A_TRACE0 + k] = I_d
        icir = I_d[:, None]
    store_state(state, rho_n, nE, rho_i, mom_i, rho_n2)


def kstep(state, prof, sacc, consts, i0: int, K: int, cfg: SolverConfig,
          physics: Physics | None = None) -> None:
    """One K-step block, in place. A CUDA tensor goes to the hand-written kernel
    (which raises if it cannot launch); a CPU tensor to the plain version."""
    if state.device.type == "cuda":
        from hallthrusterpem_tpu_torch.models.thruster import _kernels

        _kernels.kstep_cuda(state, prof, sacc, consts, i0, K, cfg)
    elif state.device.type == "cpu":
        kstep_plain(state, prof, sacc, consts, i0, K, cfg, physics)
    else:
        raise ValueError(f"kstep: unsupported device {state.device}")


def step_plain(state, extras, consts, cfg: SolverConfig, physics: Physics | None = None) -> None:
    """One timestep, in place on ``state``, writing ``extras`` (5, B, LN): the plain
    PyTorch version of the one-step CUDA kernel (``build_step_kernel``'s
    counterpart). The state is scrubbed on entry; the circuit current is read
    from scalar slot ``P_ICIR``."""
    physics = physics or Physics(cfg)
    scal = consts["scalars"]
    col = lambda s: scal[:, s : s + 1]
    dV, mdot_in, u_n, c_w, te_cath, tan_div, rc, l_dt, i_prev = (col(s) for s in range(9))
    pre = physics.loop_invariants(c_w, tan_div)
    rho_n, nE, rho_i, mom_i, rho_n2, u_i = unpack_scrubbed(cfg, state)
    new_state, (j_d, Te, ne, E_z, nn) = physics(
        rho_n, nE, rho_i, mom_i, u_i, consts["nu_anom"], consts["omega_ce"], dV, mdot_in, u_n,
        c_w, te_cath, rc, l_dt, i_prev, pre, rho_n2)
    store_state(state, *new_state)
    lane = pre["lane"]
    qs_t, qs_f = (pre["qs_t"], pre["qs_f"]) if cfg.solve_plume else (1.0, 1.0)
    extras[0] = torch.where(lane == 1, qs_t, torch.where(lane == 2, qs_f, j_d))
    for j, val in enumerate((Te, ne, E_z, nn)):
        extras[1 + j] = val


def step(state, extras, consts, cfg: SolverConfig, physics: Physics | None = None) -> None:
    """One timestep, in place. A CUDA tensor goes to the hand-written one-step
    kernel (which raises if it cannot launch); a CPU tensor to the plain version."""
    if state.device.type == "cuda":
        from hallthrusterpem_tpu_torch.models.thruster import _kernels

        _kernels.step_cuda(state, extras, consts, cfg)
    elif state.device.type == "cpu":
        step_plain(state, extras, consts, cfg, physics)
    else:
        raise ValueError(f"step: unsupported device {state.device}")


def pack_consts(params: dict, base_B: torch.Tensor, cfg: SolverConfig) -> dict:
    """Per-sample static-in-time profiles (nu_anom, omega_ce) on the lane layout
    and the packed per-sample scalar block."""
    B = params["V_d"].shape[0]
    dev = params["V_d"].device
    z = torch.as_tensor(cfg.cell_centers(), dtype=torch.float32, device=dev)
    Bfield = base_B[None, :] * params["B_hat"][:, None]
    omega = _E * Bfield / _ME
    nu_anom = anomalous_profile(params, z, cfg) * omega
    pad = lanes_for(cfg) - cfg.nc
    padp = lambda x: torch.nn.functional.pad(x, (0, pad))
    mdot_in = params["mdot_a"] + background_neutral_ingestion_flux(params["P_b"], params["f_n"], cfg)
    scalars = torch.zeros((B, N_SLOTS), dtype=torch.float32, device=dev)
    scalars[:, P_DV] = params["V_d"] - params["V_cc"]
    scalars[:, P_MDOT] = mdot_in
    scalars[:, P_UN] = torch.clamp(params["u_n"], min=10.0)
    scalars[:, P_CW] = params["c_w"]
    scalars[:, P_TECATH] = params["T_e_cath"]
    scalars[:, P_TANDIV] = params["tan_div"]
    scalars[:, P_RC] = params["circuit_R"]
    scalars[:, P_LDT] = params["circuit_L"] * (1.0 / cfg.dt)
    return {"nu_anom": padp(nu_anom).contiguous(), "omega_ce": padp(omega).contiguous(),
            "scalars": scalars}


def initial_state(params: dict, cfg: SolverConfig) -> torch.Tensor:
    """Packed (n_state, B, LN) initial state, seeded as the JAX solver seeds it."""
    B = params["V_d"].shape[0]
    dev = params["V_d"].device
    Z, mi, nc = cfg.ncharge, cfg.mi, cfg.nc
    z = torch.as_tensor(cfg.cell_centers(), dtype=torch.float32, device=dev)
    z_ch = cfg.geometry.channel_length
    L = cfg.domain[1] - cfg.domain[0]
    mdot_in = params["mdot_a"] + background_neutral_ingestion_flux(params["P_b"], params["f_n"], cfg)
    u_n = torch.clamp(params["u_n"], min=10.0)
    if cfg.neutral_groups == 2:
        # per-group injected densities: group speeds are fixed ratios of u_n,
        # the injected flux is split by fast_neutral_fraction
        fr = cfg.fast_neutral_fraction
        rho_inj = ((1.0 - fr) * mdot_in / (cfg.geometry.channel_area * cfg.slow_neutral_ratio * u_n))[:, None]
        rho_inj2 = (fr * mdot_in / (cfg.geometry.channel_area * cfg.fast_neutral_ratio * u_n))[:, None]
    else:
        rho_inj = (mdot_in / (cfg.geometry.channel_area * u_n))[:, None]
    dV = (params["V_d"] - params["V_cc"])[:, None]

    n_prof = 2e17 + 1e18 * torch.exp(-(((z - z_ch) / (0.3 * z_ch)) ** 2))
    u_bohm0 = float(np.sqrt(_E * 3.0 / mi))
    u_exit0 = torch.sqrt(2.0 * _E * torch.clamp(dV, min=50.0) / mi)
    frac = torch.clamp((z - 0.5 * z_ch) / (L - 0.5 * z_ch), 0.0, 1.0)[None, :]
    u0 = -u_bohm0 * (1.0 - frac) + u_exit0 * frac**2
    Te0 = 3.0 + 0.04 * torch.clamp(dV, min=50.0) * torch.exp(
        -(((z - z_ch) / (0.4 * z_ch)) ** 2))[None, :]

    state = torch.zeros((n_state_for(cfg), B, lanes_for(cfg)), dtype=torch.float32, device=dev)
    state[0, :, :nc] = rho_inj
    ne0 = torch.zeros((B, nc), dtype=torch.float32, device=dev)
    for zi in range(Z):
        r = torch.broadcast_to(n_prof * mi * (0.25**zi), (B, nc))
        state[2 + 2 * zi, :, :nc] = r
        state[3 + 2 * zi, :, :nc] = r * u0
        ne0 = ne0 + (zi + 1) * r / mi
    state[1, :, :nc] = 1.5 * ne0 * Te0
    if cfg.neutral_groups == 2:
        state[2 + 2 * Z, :, :nc] = rho_inj2
    return state


def finalize(params: dict, sacc, prof, consts: dict, base_B, cfg: SolverConfig) -> dict:
    """Time averages, NaN rows for failed samples and the derived efficiencies."""
    B = params["V_d"].shape[0]
    NC, Z, mi = cfg.nc, cfg.ncharge, cfg.mi
    failed = sacc[:, A_FAILED] > 0.5
    accum = {
        "thrust": sacc[:, A_THRUST], "I_d": sacc[:, A_ID], "I_d2": sacc[:, A_ID2],
        "I_B0": sacc[:, A_IB0], "mdot_ion": sacc[:, A_MDOT], "u_exit1": sacc[:, A_UEXIT],
        "ui": torch.stack([prof[z][:, :NC] for z in range(Z)], dim=1),
        "Te": prof[Z][:, :NC], "ne": prof[Z + 1][:, :NC],
        "E": prof[Z + 2][:, :NC], "nn": prof[Z + 3][:, :NC],
    }
    n_avg = float(max(cfg.num_steps - cfg.avg_start_step, 1))
    nanify = lambda v: torch.where(failed.reshape((B,) + (1,) * (v.ndim - 1)), torch.nan, v / n_avg)
    avg = {k: nanify(v) for k, v in accum.items()}

    thrust, I_d, I_B0 = avg["thrust"], avg["I_d"], avg["I_B0"]
    E_avg = avg["E"]
    zeros = torch.zeros((B, 1), dtype=E_avg.dtype, device=E_avg.device)
    phi = params["V_d"][:, None] - torch.cat(
        [zeros, torch.cumsum(0.5 * (E_avg[:, 1:] + E_avg[:, :-1]) * cfg.dz, dim=1)], dim=1)
    z = torch.as_tensor(cfg.cell_centers(), dtype=torch.float32, device=E_avg.device)
    return {
        "thrust": thrust,
        "discharge_current": I_d,
        "discharge_current_std": torch.sqrt(torch.clamp(avg["I_d2"] - I_d**2, min=0.0)),
        "ion_current": I_B0,
        "current_eff": I_B0 / I_d,
        "mass_eff": avg["mdot_ion"] / params["mdot_a"],
        "voltage_eff": avg["u_exit1"] ** 2 * mi / (2 * _E * torch.clamp(params["V_d"], min=1.0)),
        "anode_eff": thrust**2 / (2 * params["mdot_a"] * torch.clamp(I_d * params["V_d"], min=1e-6)),
        "ui": avg["ui"],
        "z": torch.broadcast_to(z, (B, NC)),
        "Tev": avg["Te"],
        "ne": avg["ne"],
        "nn": avg["nn"],
        "potential": phi,
        "E": E_avg,
        "nu_anom": consts["nu_anom"][:, :NC],
        "B": base_B[None, :] * params["B_hat"][:, None],
    }


def init_carry(params: dict, base_B, cfg: SolverConfig):
    """(consts, state, prof, sacc) at step 0 of a K-step run."""
    check_supported(cfg)
    B = params["V_d"].shape[0]
    dev = params["V_d"].device
    consts = pack_consts(params, base_B, cfg)
    state = initial_state(params, cfg)
    prof = torch.zeros((cfg.ncharge + 4, B, lanes_for(cfg)), dtype=torch.float32, device=dev)
    sacc = torch.zeros((B, N_SLOTS), dtype=torch.float32, device=dev)
    sacc[:, A_ICIR] = (_E / cfg.mi) * params["mdot_a"]
    return consts, state, prof, sacc


def simulate_batch_multi(params: dict, base_B: torch.Tensor, cfg: SolverConfig,
                         inner_steps: int = INNER_STEPS, block=None) -> dict:
    """Whole time loop as ceil(num_steps / K) K-step blocks, then the time
    averages (the counterpart of ``simulate_batch_pallas_multi``). Runs where
    ``params`` lie: on a CUDA device through the kernel, with no host sync between
    blocks; on the CPU through the plain version. There is no batch padding: the
    kernel runs one thread block per sample.

    ``cfg.num_save > 0`` also returns ``discharge_current_trace`` (B, num_save), the
    discharge current at steps ``save_idx = arange(num_save) * stride`` with
    ``stride = max(1, num_steps // num_save)`` (NaN rows for failed samples), and
    ``trace_times = (save_idx + 1) * dt``. Each launch sets its steps' currents in
    the trace lanes of ``sacc``, and one strided copy per launch gathers the save
    points that fall in it (at most 120 steps a launch then).

    ``block`` replaces the K-step function (default :func:`kstep`); passing
    :func:`kstep_plain` runs the plain version on any device, for comparisons."""
    if inner_steps <= 0:
        raise ValueError(f"inner_steps={inner_steps}: must be a positive integer")
    block = block or kstep
    trace = cfg.num_save > 0
    if trace:
        inner_steps = min(inner_steps, MAX_TRACE_STEPS)
    params = {k: v.to(torch.float32) for k, v in params.items()}
    base_B = base_B.to(device=params["V_d"].device, dtype=torch.float32)
    consts, state, prof, sacc = init_carry(params, base_B, cfg)
    physics = Physics(cfg) if block is kstep_plain or state.device.type == "cpu" else None
    stride = max(1, cfg.num_steps // cfg.num_save) if trace else 1
    traces = torch.zeros((state.shape[1], cfg.num_save), dtype=torch.float32, device=state.device)
    for i0 in range(0, cfg.num_steps, inner_steps):
        block(state, prof, sacc, consts, i0, inner_steps, cfg, physics)
        # save points n * stride in [i0, i0 + K): block-local trace lanes n * stride - i0
        n0 = -(-i0 // stride)
        n1 = min(cfg.num_save, -(-(i0 + inner_steps) // stride))
        if n1 > n0:
            lane0 = A_TRACE0 + n0 * stride - i0
            traces[:, n0:n1] = sacc[:, lane0 : lane0 + (n1 - n0 - 1) * stride + 1 : stride]
    out = finalize(params, sacc, prof, consts, base_B, cfg)
    if trace:
        failed = sacc[:, A_FAILED] > 0.5
        save_idx = torch.arange(cfg.num_save, device=state.device) * stride
        out["discharge_current_trace"] = torch.where(failed[:, None], torch.nan, traces)
        out["trace_times"] = torch.broadcast_to((save_idx.float() + 1.0) * cfg.dt, traces.shape)
    return out


def from_jax_numpy(params: dict, base_B: np.ndarray, device) -> tuple[dict, torch.Tensor]:
    """The JAX package's ``make_params`` dict and B-field profile, as numpy, to the
    port's float32 tensors on ``device``."""
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return {k: t(v) for k, v in params.items()}, t(base_B)
