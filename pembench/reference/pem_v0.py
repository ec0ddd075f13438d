"""Plain reference of the pem_v0 coupled system: cathode coupling -> 1-D Hall
discharge -> ion-current-density plume, over a batch of input rows.

It imports nothing of the program under test. The physics is a frozen copy of
the plain PyTorch equations that the program's CUDA kernel implements (one
timestep of the discharge on a (rows, lanes) layout, the reaction-rate fits,
the anomalous-transport profile, the plume's erfi normalisation), written in
one precision given by the caller: ``torch.float32`` is the precision the
configuration states, ``torch.bfloat16`` is the control. The input tree of
HallThruster.jl (fidelity, adaptive time step, guards, cycle average) is read
from the frozen configuration file, and the device (geometry, magnetic field)
from a frozen copy under ``pembench/data/devices``.

On a CUDA device the time loop replays two CUDA graphs of one step each (with
and without the running sums), so that a check run pays about a millisecond a
step; on the CPU it runs the same step eagerly. Entry point: :func:`predict`.
"""

from __future__ import annotations

import copy
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

E = 1.602176634e-19  # C
ME = 9.1093837015e-31  # kg
KB = 1.380649e-23  # J/K
AVOGADRO = 6.02214076e23
TORR_2_PA = 133.322368421
MOLECULAR_WEIGHTS = {"Xenon": 131.293, "Krypton": 83.798, "Argon": 39.948}
K_EN = {"Xenon": 2.5e-13, "Krypton": 1.8e-13, "Argon": 1.0e-13}
DEVICES = Path(__file__).resolve().parents[1] / "data" / "devices"

#: every output the comparison reads, by component
OUTPUTS = {"Cathode": ("V_cc",),
           "Thruster": ("T", "I_d", "I_B0", "eta_c", "eta_m", "eta_v", "eta_a", "u_ion", "discharge_current_trace"),
           "Plume": ("j_ion", "div_angle")}


def atomic_mass(propellant: str) -> float:
    return MOLECULAR_WEIGHTS[propellant] / AVOGADRO / 1000.0


# ------------------------------------------------------------------------------- rates
TE_MIN, TE_MAX, N_TABLE = 0.3, 150.0, 256
TE_GRID = 10.0 ** np.linspace(np.log10(TE_MIN), np.log10(TE_MAX), N_TABLE)
_IZ_ENERGY = {"Xenon": {1: 12.1298, 2: 20.975, 3: 31.05}, "Krypton": {1: 13.9996, 2: 24.36, 3: 36.95}}
_EX_ENERGY = {"Xenon": 8.32, "Krypton": 9.915}
_LOTZ_Q = {0: 6, 1: 5, 2: 4}


def _fit(table) -> np.ndarray:
    """ln k as a degree-10 polynomial in ln Te over TE_GRID (k floored at 1e-32)."""
    return np.polyfit(np.log(TE_GRID), np.log(np.maximum(np.asarray(table, np.float64), 1e-32)), 10)


def _maxwellian_rate(sigma, te) -> np.ndarray:
    x = np.linspace(1e-4, 40.0, 4000)
    out = np.zeros_like(te)
    for i, t in enumerate(te):
        vbar = np.sqrt(8 * E * t / (np.pi * ME))
        out[i] = vbar * np.sum(sigma(x * t) * x * np.exp(-x)) * (x[1] - x[0])
    return out


def _lotz(p_ev: float, q: int, a: float = 4.0e-18, b: float = 0.6, c: float = 0.56):
    def sigma(en):
        en = np.asarray(en, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            s = a * q * np.log(np.maximum(en / p_ev, 1.0)) / (en * p_ev) * (
                1.0 - b * np.exp(-c * (en / p_ev - 1.0)))
        return np.where(en > p_ev, np.maximum(s, 0.0), 0.0)
    return sigma


def rate_fits(propellant: str, ncharge: int):
    """([(coeffs, dcoeffs, z_from, z_to, energy)] per ionisation reaction,
    (coeffs, dcoeffs, energy) of excitation): Goebel & Katz for Xe single
    ionisation and excitation, Maxwellian-averaged Lotz otherwise."""
    energies = _IZ_ENERGY[propellant]
    rxn = []
    for z_from in range(ncharge):
        for z_to in range(z_from + 1, ncharge + 1):
            cost = sum(energies[z] for z in range(z_from + 1, z_to + 1))
            if z_from == 0 and z_to == 1 and propellant == "Xenon":
                te = TE_GRID
                vbar = np.sqrt(8 * E * te / (np.pi * ME))
                gk = 1e-20 * np.maximum(3.97 + 0.643 * te - 0.0368 * te**2, 0.0) * np.exp(-12.127 / te) * vbar
                w = np.clip((te - 10.0) / 8.0, 0.0, 1.0)
                raw = (1.0 - w) * gk + w * _maxwellian_rate(_lotz(12.1298, 6), te)
            else:
                raw = 0.2 ** (z_to - z_from - 1) * _maxwellian_rate(
                    _lotz(cost, _LOTZ_Q.get(z_from, 3), b=0.6 if z_from == 0 else 0.0), TE_GRID)
            c = _fit(raw)
            rxn.append((c, np.polyder(c), z_from, z_to, cost))
    if propellant == "Xenon":
        vbar = np.sqrt(8 * E * TE_GRID / (np.pi * ME))
        ex_raw, ex_energy = 1.93e-19 * np.exp(-11.6 / TE_GRID) / np.sqrt(TE_GRID) * vbar, _EX_ENERGY["Xenon"]
    else:
        ex_energy = _EX_ENERGY.get(propellant, 10.0)
        ex_raw = _maxwellian_rate(_lotz(ex_energy, 6), TE_GRID) * 2.0
    ex = _fit(ex_raw)
    return rxn, (ex, np.polyder(ex), ex_energy)


def _poly(coeffs, x):
    """Horner's rule; ``coeffs`` (degree + 1, ...) broadcast against ``x``."""
    out = coeffs[0] * x + coeffs[1]
    for c in coeffs[2:]:
        out = out * x + c
    return out


# ------------------------------------------------------------------------------ grid
@dataclass(frozen=True)
class Grid:
    """What one call of the discharge solve fixes for all its rows."""

    num_cells: int
    ncharge: int
    dt: float
    duration: float
    average_start_time: float
    domain: tuple = (0.0, 0.08)
    channel_length: float = 0.025
    inner_radius: float = 0.0345
    outer_radius: float = 0.05
    propellant: str = "Xenon"
    anom_model: str = "TwoZoneBohm"
    pressure_shift: str = "none"
    ion_wall_losses: bool = True
    solve_plume: bool = False
    div_corr: bool = False
    neutral_groups: int = 1
    num_save: int = 0
    cycle_average: bool = False
    anom_barrier_width: float = 2.5e-3
    anode_alpha: float = 0.03
    anode_edge_frac: float = 0.55
    anode_edge_width: float = 1.5e-3
    wall_recycling: float = 0.78
    # fixed physics constants of the model
    ion_temp_K: float = 1000.0
    background_temp_K: float = 150.0
    ne_floor: float = 1e12
    Te_min: float = 0.5
    Te_max: float = 150.0
    anode_Te: float = 2.0
    see_crossover_eV: float = 45.0
    see_gamma_max: float = 0.983
    fast_neutral_fraction: float = 0.25
    fast_neutral_ratio: float = 2.2
    slow_neutral_ratio: float = 0.6
    #: lanes of a row (0: the solver's layout, 128 or 256)
    lane_count: int = 0

    @property
    def nc(self) -> int:
        return self.num_cells + 2

    @property
    def lanes(self) -> int:
        return self.lane_count or (128 if self.nc <= 126 else 256)

    @property
    def dz(self) -> float:
        return (self.domain[1] - self.domain[0]) / self.num_cells

    @property
    def mi(self) -> float:
        return atomic_mass(self.propellant)

    @property
    def area(self) -> float:
        return float(np.pi * (self.outer_radius**2 - self.inner_radius**2))

    @property
    def gap(self) -> float:
        return self.outer_radius - self.inner_radius

    @property
    def num_steps(self) -> int:
        return max(1, int(round(self.duration / self.dt)))

    @property
    def avg_start_step(self) -> int:
        return min(self.num_steps - 1, int(round(self.average_start_time / self.dt)))

    def cell_centers(self) -> np.ndarray:
        z0, z1 = self.domain
        return np.concatenate([[z0], z0 + (np.arange(self.num_cells) + 0.5) * self.dz, [z1]])


def _nan_extreme(x, largest: bool) -> float:
    t = torch.as_tensor(x, dtype=torch.float64).reshape(-1).cpu().numpy()
    t = t[~np.isnan(t)]
    return float("nan") if t.size == 0 else float(t.max() if largest else t.min())


def _cfl_dt(num_cells: int, ncharge: int, config: dict, cfl: float = 0.2) -> float:
    """The time step a CFL number of ``cfl`` allows the fastest ion of the batch."""
    domain = config.get("domain", [0, 0.08])
    mi = atomic_mass(config.get("propellant", "Xenon"))
    drop = _nan_extreme(config.get("discharge_voltage", 300), True) - _nan_extreme(
        config.get("cathode_coupling_voltage", 0), False)
    u = np.sqrt(2 * ncharge * E * max(drop, 1.0) / mi)
    return float(cfl * (float(domain[1]) / (num_cells + 1)) / u)


def make_grid(thruster: dict, fidelity: tuple, config: dict) -> Grid:
    """The grid of one call: ``thruster`` is the component's entry of the
    configuration file, ``config`` its ``config`` section with the call's
    inputs set (``discharge_voltage`` and ``cathode_coupling_voltage`` arrays)."""
    sim, post = thruster.get("simulation", {}), thruster.get("postprocess", {})
    num_cells, ncharge = 50 * (fidelity[0] + 2), fidelity[1] + 1
    domain = config.get("domain", (0.0, 0.08))
    dt = _cfl_dt(num_cells, ncharge, config)
    if sim.get("adaptive"):
        dt_fid = _cfl_dt(100, ncharge, config)
        dx = (float(domain[1]) - float(domain[0])) / (num_cells + 1)
        dt_cfl = dt_fid * dx / (float(domain[1]) / (100 + 1))
        dt = float(np.clip(dt_cfl, float(sim.get("min_dt", dt_cfl)), float(sim.get("max_dt", dt_cfl))))
    duration = float(sim.get("duration", 1e-3))
    anom = config.get("anom_model", {}) or {}
    shift, inner = "none", anom
    if anom.get("type") in ("LogisticPressureShift", "SimpleLogisticShift"):
        shift, inner = anom["type"], anom.get("model", {}) or {}
    device = load_device(thruster.get("thruster", "SPT-100"))
    geom = device.get("geometry", {})
    shape = {k: float(config[k]) for k in ("anode_alpha", "anode_edge_frac", "anode_edge_width",
                                          "anom_barrier_width", "wall_recycling") if config.get(k) is not None}
    return Grid(num_cells=num_cells, ncharge=ncharge, dt=dt, duration=duration,
                average_start_time=float(post.get("average_start_time", 0.5 * duration)),
                domain=(float(domain[0]), float(domain[1])),
                channel_length=float(geom.get("channel_length", 0.025)),
                inner_radius=float(geom.get("inner_radius", 0.0345)),
                outer_radius=float(geom.get("outer_radius", 0.05)),
                propellant=str(config.get("propellant", "Xenon")),
                anom_model=inner.get("type", "TwoZoneBohm"), pressure_shift=shift,
                ion_wall_losses=bool(config.get("ion_wall_losses", True)),
                solve_plume=bool(config.get("solve_plume", False)),
                div_corr=bool(config.get("apply_thrust_divergence_correction", False)),
                neutral_groups=int(config.get("neutral_groups", 1)),
                num_save=int(sim.get("num_save", 0)), cycle_average=bool(post.get("cycle_average")),
                **shape)


def load_device(name: str) -> dict:
    with open(DEVICES / name / "thruster.json", encoding="utf-8") as fd:
        return json.load(fd)


def bfield(grid: Grid, device_name: str) -> torch.Tensor:
    """The device's field [T] on the cell centres, interpolated in float32."""
    raw = np.genfromtxt(DEVICES / device_name / load_device(device_name)["magnetic_field"]["file"],
                        delimiter=",", skip_header=1)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    xq, xp, fp = f32(grid.cell_centers()), f32(raw[:, 0]), f32(raw[:, 1])
    idx = torch.clamp(torch.searchsorted(xp, xq, right=True) - 1, 0, xp.shape[0] - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    w = torch.clamp(torch.where(x1 > x0, (xq - x0) / (x1 - x0), torch.zeros_like(xq)), 0.0, 1.0)
    return fp[idx] * (1 - w) + fp[idx + 1] * w


# -------------------------------------------------------------------- per-row inputs
_DEFAULTS = {"V_d": 300.0, "V_cc": 0.0, "mdot_a": 5e-6, "P_b": 0.0, "T_e_cath": 3.0, "u_n": 300.0,
             "l_t": 0.003, "a1": 0.00625, "a2": 0.0625, "hall_min": 0.00625, "hall_max": 0.0625,
             "center": 0.025, "width": 0.005, "shift_dz": 0.2, "shift_z0": 0.0, "shift_pstar": 45.0e-6,
             "shift_alpha": 15.0, "anom_depth": 0.904, "anom_width": 0.0, "f_n": 1.0, "c_w": 1.0,
             "B_hat": 1.0, "tan_div": 0.1835, "circuit_R": 0.0, "circuit_L": 0.0}

#: PEM input name -> its path in the input tree
_TREE_PATHS = {"P_b": ("background_pressure_Torr",), "mdot_a": ("anode_mass_flow_rate",),
               "V_cc": ("cathode_coupling_voltage",), "u_n": ("neutral_velocity",), "T_e": ("cathode_Tev",),
               "l_t": ("transition_length",), "V_a": ("discharge_voltage",), "dz": ("anom_model", "dz"),
               "z0": ("anom_model", "z0"), "p0": ("anom_model", "pstar"), "alpha": ("anom_model", "alpha"),
               "a_1": ("anom_model", "model", "c1"), "a_2": ("anom_model", "model", "c2"),
               "anom_min": ("anom_model", "model", "hall_min"), "anom_max": ("anom_model", "model", "hall_max"),
               "anom_center": ("anom_model", "model", "center"), "anom_width": ("anom_model", "model", "width"),
               "anom_barrier_scale": ("anom_model", "model", "barrier_scale"),
               "anom_shift_length": ("anom_model", "shift_length"), "f_n": ("neutral_ingestion_multiplier",),
               "R_c": ("circuit", "R"), "L_c": ("circuit", "L"), "c_w": ("wall_loss_model", "loss_scale"),
               "B_hat": ("magnetic_field_scale",)}


def input_config(thruster: dict, rows: dict) -> dict:
    """The ``config`` section of the input tree with each row input (float32
    tensors) set at its path."""
    config = copy.deepcopy(thruster.get("config", {}))
    for name, value in rows.items():
        node = config
        path = _TREE_PATHS[name]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    anom = config.get("anom_model")
    if anom:
        inner = anom["model"] if isinstance(anom.get("model"), dict) else anom
        if inner.get("type", "TwoZoneBohm") == "TwoZoneBohm" and rows.get("a_2") is not None:
            inner["c2"] = inner["c2"] * inner.get("c1", 0.00625)
        elif inner.get("type") == "GaussianBohm" and rows.get("anom_max") is not None:
            inner["hall_max"] = inner["hall_max"] * inner.get("hall_min", 0.00625)
    return config


def solver_params(config: dict, rows: int, device) -> dict:
    """Per-row float32 solver parameters (rows,) from an input ``config``."""
    anom = config.get("anom_model", {}) or {}
    shifted = anom.get("type") in ("LogisticPressureShift", "SimpleLogisticShift")
    inner = (anom.get("model", {}) or {}) if shifted else anom
    over = {}
    for name, path in (("V_d", ("discharge_voltage",)), ("V_cc", ("cathode_coupling_voltage",)),
                       ("mdot_a", ("anode_mass_flow_rate",)), ("P_b", ("background_pressure_Torr",)),
                       ("T_e_cath", ("cathode_Tev",)), ("u_n", ("neutral_velocity",)),
                       ("l_t", ("transition_length",)), ("f_n", ("neutral_ingestion_multiplier",)),
                       ("B_hat", ("magnetic_field_scale",)), ("tan_div", ("plume_divergence_tan",)),
                       ("circuit_R", ("circuit", "R")), ("circuit_L", ("circuit", "L"))):
        node = config
        for key in path[:-1]:
            node = node.get(key, {}) if isinstance(node, dict) else {}
        if isinstance(node, dict) and node.get(path[-1]) is not None:
            over[name] = node[path[-1]]
    wall = config.get("wall_loss_model", {}) or {}
    if wall.get("loss_scale") is not None:
        over["c_w"] = wall["loss_scale"]
    for src, dst in (("c1", "a1"), ("c2", "a2"), ("hall_min", "hall_min"), ("hall_max", "hall_max"),
                     ("center", "center"), ("width", "width"), ("barrier_scale", "anom_depth"),
                     ("barrier_width", "anom_width")):
        if inner.get(src) is not None:
            over[dst] = inner[src]
    for src, dst in (("dz", "shift_dz"), ("z0", "shift_z0"), ("pstar", "shift_pstar"),
                     ("alpha", "shift_alpha"), ("shift_length", "shift_dz")):
        if anom.get(src) is not None:
            over[dst] = anom[src]
    return {k: torch.broadcast_to(torch.as_tensor(over.get(k, v), dtype=torch.float32, device=device),
                                  (rows,)) for k, v in _DEFAULTS.items()}


def ingestion(P_b, f_n, g: Grid):
    """Facility neutrals ingested through the exit plane [kg/s]."""
    root = float(np.sqrt(np.float32(g.mi / (2 * math.pi * KB * g.background_temp_K))))
    return f_n * (P_b * TORR_2_PA * root) * g.area


def anomalous_profile(p: dict, z: torch.Tensor, g: Grid) -> torch.Tensor:
    col = lambda k: p[k][:, None]
    z_ch = g.channel_length
    shift = 0.0
    if g.pressure_shift != "none":
        sig = torch.sigmoid(p["shift_alpha"] * (p["P_b"] / p["shift_pstar"] - 1.0))
        shift = (p["shift_dz"] * (1.0 - sig) * z_ch if g.pressure_shift == "SimpleLogisticShift"
                 else (p["shift_z0"] + p["shift_dz"] * (1.0 - sig)) * z_ch)[:, None]
    if g.anom_model == "GaussianBohm":
        zc = col("center") + shift
        return col("hall_max") + (col("hall_min") - col("hall_max")) * torch.exp(
            -0.5 * ((z - zc) / torch.clamp(col("width"), min=1e-4)) ** 2)
    z_tr = z_ch + shift
    w = 0.5 * (1.0 + torch.tanh(2.0 * (z - z_tr) / torch.clamp(col("l_t"), min=1e-4)))
    alpha = col("a1") + (col("a2") - col("a1")) * w
    if g.anom_barrier_width > 0:
        aw = col("anom_width")
        width = torch.where(aw > 0, aw, g.anom_barrier_width)
        well = torch.exp(-0.5 * ((z - z_tr) / width) ** 2)
        alpha = alpha + well * (col("a1") * (1.0 - torch.clamp(col("anom_depth"), 0.0, 0.98)) - alpha)
    if g.anode_alpha > 0:
        edge = g.anode_edge_frac * z_ch + shift
        alpha = alpha + g.anode_alpha * (0.5 * (1.0 - torch.tanh((z - edge) / g.anode_edge_width)))
    return alpha


# --------------------------------------------------------------------- the discharge
def _roll(x, shift: int):
    return torch.roll(x, shift, dims=1)


class Physics:
    """One timestep of the discharge on (rows, lanes) tensors in ``dtype``."""

    def __init__(self, g: Grid, dtype: torch.dtype):
        self.g, self.dtype = g, dtype
        self.NC, self.LN, self.Z, self.G = g.nc, g.lanes, g.ncharge, g.neutral_groups
        self.rxn, self.ex = rate_fits(g.propellant, g.ncharge)
        # every fit (ionisations, then excitation) evaluated at once: (degree + 1, fits, 1, 1)
        fits = [r[:2] for r in self.rxn] + [self.ex[:2]]
        self._fits = [np.stack([f[j] for f in fits], axis=1)[:, :, None, None] for j in (0, 1)]
        self._fit_tensors = {}

    def invariants(self, c_w, tan_div) -> dict:
        g, NC, dt = self.g, self.NC, self.dtype
        B = c_w.shape[0]
        inv_dz = 1.0 / g.dz
        lane = torch.arange(self.LN, device=c_w.device).expand(B, self.LN)
        interior = (lane >= 1) & (lane <= NC - 2)
        z_cell = torch.where(lane == 0, 0.0, (lane.to(dt) - 0.5) * g.dz)
        z_cell = torch.where(lane >= NC - 1, g.domain[1] - g.domain[0], z_cell).to(dt)
        in_channel = (z_cell <= g.channel_length).to(dt)
        pre = dict(lane=lane, interior=interior, in_domain=lane <= NC - 1, interior_f=interior.to(dt),
                   face_f=(lane <= NC - 2).to(dt), in_channel=in_channel, nu_ew=0.0 * c_w * in_channel)
        if g.solve_plume:
            tand = torch.clamp(tan_div, 0.0, 2.0)
            drz = tand * torch.clamp(z_cell - g.channel_length, min=0.0)
            r_o = g.outer_radius + drz
            r_i = torch.clamp(g.inner_radius - drz, min=0.0)
            AR = (r_o * r_o - r_i * r_i) * (1.0 / (g.outer_radius**2 - g.inner_radius**2))
            inv_AR = 1.0 / AR
            AR_f = 0.5 * (AR + _roll(AR, -1))
            ARf_m = _roll(AR_f, 1)
            ar_ex = AR[:, NC - 2][:, None]
            pre.update(AR_f=AR_f, inv_AR=inv_AR, dlnA=(AR_f - ARf_m) * inv_dz * inv_AR * pre["interior_f"],
                       wp=AR_f * inv_AR, wm=ARf_m * inv_AR, qs_f=ar_ex,
                       qs_t=ar_ex * torch.rsqrt(1.0 + tand * tand) if g.div_corr else ar_ex)
        return pre

    def wall_energy_loss(self, Te, ne, in_channel, c_w, lnTe, rs_te):
        g = self.g
        gamma = torch.clamp(1.4 * torch.exp(0.576 * (lnTe - float(np.log(g.see_crossover_eV)))),
                            max=g.see_gamma_max)
        one_m_g = 1.0 - gamma
        phi = torch.clamp(torch.log(one_m_g * float(np.sqrt(g.mi / (2 * np.pi * ME)))), min=0.0)
        coef = float(0.6 * np.sqrt(E / g.mi) / g.gap / 1.5)
        return (coef * c_w) * (Te * rs_te) / one_m_g * (2.0 + phi) * in_channel

    def __call__(self, rho_n, nE, rho_i, mom_i, u_i, nu_anom, omega_ce, dV, mdot_in, u_n,
                 c_w, te_cath, rc, l_dt, i_prev, pre, rho_n2=None):
        """Advance one step. Returns ``(rho_n', nE', rho_i', mom_i', rho_n2'),
        (j_d, Te, ne, E_z, nn)``; per-row scalars are (rows, 1)."""
        g, NC, Z, G = self.g, self.NC, self.Z, self.G
        dz, dt, mi = g.dz, g.dt, g.mi
        A_ch = g.area
        a_i = float(np.sqrt(1.380649e-23 * g.ion_temp_K / mi))
        zq = [float(z) for z in range(1, Z + 1)]
        k_en = K_EN.get(g.propellant, 2.5e-13)
        rho_floor = float(1e10 * mi)
        inv_mi, inv_dz, inv_dt = 1.0 / mi, 1.0 / dz, 1.0 / dt
        lane, interior, in_domain = pre["lane"], pre["interior"], pre["in_domain"]
        interior_f, face_f, in_channel = pre["interior_f"], pre["face_f"], pre["in_channel"]

        ni = [r * inv_mi for r in rho_i]
        ne = ni[0] * zq[0]
        for z in range(1, Z):
            ne = ne + zq[z] * ni[z]
        ne = torch.clamp(ne, min=g.ne_floor)
        inv_ne = 1.0 / ne
        Te = torch.clamp((2.0 / 3.0) * nE * inv_ne, g.Te_min, g.Te_max)
        if G == 2:
            nn_g0, nn_g1 = rho_n * inv_mi, rho_n2 * inv_mi
            nn = torch.clamp(nn_g0 + nn_g1, min=1e6)
            inv_nn = 1.0 / nn
            share0, share1 = nn_g0 * inv_nn, nn_g1 * inv_nn
            u_g0, u_g1 = g.slow_neutral_ratio * u_n, g.fast_neutral_ratio * u_n
            u_n_src = share0 * u_g0 + share1 * u_g1
        else:
            nn = torch.clamp(rho_n * inv_mi, min=1e6)
            u_n_src = u_n

        lnTe = torch.log(Te)
        lnL = torch.clamp(23.0 - 0.5 * torch.log(ne * 1e-6) + 1.5 * lnTe, 2.0, 30.0)
        rs_te = torch.rsqrt(Te)
        nu_ei = 2.9e-12 * ne * lnL * (rs_te * rs_te * rs_te)
        nu_e = k_en * nn + nu_ei + nu_anom + pre["nu_ew"]
        mu = (E / ME) * nu_e / (nu_e * nu_e + omega_ce * omega_ce)
        inv_AR = pre["inv_AR"] if g.solve_plume else 1.0

        # Ohm's law, integrated over the channel, with the RL circuit
        j_i = zq[0] * ni[0] * u_i[0]
        for z in range(1, Z):
            j_i = j_i + zq[z] * ni[z] * u_i[z]
        j_i = E * j_i
        pe = ne * Te
        grad_pe = (_roll(pe, -1) - _roll(pe, 1)) * (0.5 * inv_dz)
        grad_pe = torch.where(lane == 0, (_roll(pe, -1) - pe) * inv_dz, grad_pe)
        grad_pe = torch.where(lane == NC - 1, (pe - _roll(pe, 1)) * inv_dz, grad_pe)
        grad_pe = torch.where(in_domain, grad_pe, 0.0)
        inv_enmu = 1.0 / (E * ne * mu)
        gpe_ne = grad_pe * inv_ne
        num_igd = (j_i * inv_enmu + gpe_ne) * interior_f
        den_igd = (inv_AR * inv_enmu * interior_f) if g.solve_plume else (inv_enmu * interior_f)
        num_int = torch.sum(num_igd, dim=1, keepdim=True) * dz
        i_prev = torch.clamp(i_prev, -1e4, 1e4)
        den_pl = torch.sum(den_igd, dim=1, keepdim=True) * dz + rc * A_ch
        den_all = den_pl + l_dt * A_ch
        j_prev = i_prev * (1.0 / A_ch)
        ne1, Te1, j_i1 = ne[:, 1:2], Te[:, 1:2], j_i[:, 1:2]
        j_d = j_prev + (dV + num_int - j_prev * den_pl) / den_all
        j_e_th = E * ne1 * torch.sqrt(E * Te1 / (2.0 * np.pi * ME))
        j_e_req = torch.maximum(j_d - j_i1, 1e-6 * j_e_th)
        phi_s = torch.clamp(Te1 * torch.log(j_e_th / j_e_req), min=torch.zeros_like(dV), max=0.5 * torch.abs(dV))
        j_d = j_prev + (dV - phi_s + num_int - j_prev * den_pl) / den_all
        j_d_loc = j_d * inv_AR if g.solve_plume else j_d
        E_z = (j_d_loc - j_i) * inv_enmu - gpe_ne

        # ghost cells
        u_bohm1 = torch.sqrt(E * Te[:, 1:2] / mi)
        mom_back = torch.zeros_like(dV)
        for z in range(Z):
            mom_back = mom_back + torch.clamp(mom_i[z][:, 1:2], max=0.0)
        if G == 2:
            fr = g.fast_neutral_fraction
            rho_n_l = ((1.0 - fr) * (mdot_in / A_ch) - mom_back) / u_g0
            rho_n2_b = torch.where(lane == 0, (fr * (mdot_in / A_ch)) / u_g1, rho_n2)
            rho_n2_b = torch.where(lane == NC - 1, _roll(rho_n2, 1), rho_n2_b)
        else:
            rho_n_l = (mdot_in / A_ch - mom_back) / u_n
        rho_n_b = torch.where(lane == 0, rho_n_l, rho_n)
        rho_n_b = torch.where(lane == NC - 1, _roll(rho_n, 1), rho_n_b)
        rho_b, mom_b = [], []
        bohm_c = [float(np.float32(-1.0) * np.sqrt(np.float32(z_), dtype=np.float32)) for z_ in zq]
        for z in range(Z):
            u_gl = torch.minimum(u_i[z][:, 1:2], bohm_c[z] * u_bohm1)
            r_gl = rho_i[z][:, 1:2]
            rb = torch.where(lane == 0, r_gl, rho_i[z])
            rho_b.append(torch.where(lane == NC - 1, _roll(rho_i[z], 1), rb))
            mb = torch.where(lane == 0, r_gl * u_gl, mom_i[z])
            mom_b.append(torch.where(lane == NC - 1, _roll(mom_i[z], 1), mb))

        # MUSCL-minmod reconstruction and HLLE fluxes through face i (cells i, i+1)
        def slope(q):
            dq_p = _roll(q, -1) - q
            dq_m = _roll(dq_p, 1)
            return 0.5 * (torch.sign(dq_m) + torch.sign(dq_p)) * torch.minimum(
                torch.abs(dq_m), torch.abs(dq_p)) * interior_f

        if G == 2:
            Fn = u_g0 * torch.clamp(rho_n_b + 0.5 * slope(rho_n_b), min=rho_floor) * face_f
            Fn2 = u_g1 * torch.clamp(rho_n2_b + 0.5 * slope(rho_n2_b), min=rho_floor) * face_f
        else:
            Fn = u_n * torch.clamp(rho_n_b + 0.5 * slope(rho_n_b), min=rho_floor) * face_f
        Fr, Fm = [], []
        for z in range(Z):
            u_b = mom_b[z] / torch.clamp(rho_b[z], min=rho_floor)
            sl_r, sl_u = slope(rho_b[z]), slope(u_b)
            rL = torch.clamp(rho_b[z] + 0.5 * sl_r, min=rho_floor)
            rR = torch.clamp(_roll(rho_b[z] - 0.5 * sl_r, -1), min=rho_floor)
            uL = u_b + 0.5 * sl_u
            uR = _roll(u_b - 0.5 * sl_u, -1)
            mL, mR = rL * uL, rR * uR
            sL = torch.clamp(torch.minimum(uL - a_i, uR - a_i), max=0.0)
            sR = torch.clamp(torch.maximum(uL + a_i, uR + a_i), min=0.0)
            inv_ds = face_f / torch.clamp(sR - sL, min=1e-8)
            FmL, FmR = mL * uL + rL * (a_i * a_i), mR * uR + rR * (a_i * a_i)
            Fr.append((sR * mL - sL * mR + sL * sR * (rR - rL)) * inv_ds)
            Fm.append((sR * FmL - sL * FmR + sL * sR * (mR - mL)) * inv_ds)
        if g.solve_plume:
            AR_f = pre["AR_f"]
            ddz = lambda F: ((F * AR_f) - _roll(F * AR_f, 1)) * inv_dz * inv_AR
        else:
            ddz = lambda F: (F - _roll(F, 1)) * inv_dz

        # sources: ionisation and excitation, electric force, area change, ion-wall losses
        d_rho_n = torch.zeros_like(rho_n)
        d_rho_n2 = torch.zeros_like(rho_n) if G == 2 else None
        d_rho = [torch.zeros_like(rho_n) for _ in range(Z)]
        d_mom = [torch.zeros_like(rho_n) for _ in range(Z)]
        inelastic = torch.zeros_like(rho_n)
        dinel = torch.zeros_like(rho_n)
        inv_Te = 1.0 / Te
        fits = self._fit_tensors.get(lnTe.device)
        if fits is None:
            fits = self._fit_tensors[lnTe.device] = [torch.as_tensor(f, dtype=self.dtype, device=lnTe.device)
                                                     for f in self._fits]
        rates = torch.exp(_poly(fits[0], lnTe))  # (fits, rows, lanes)
        slopes = _poly(fits[1], lnTe)
        for r, (_, _, z_from, z_to, energy) in enumerate(self.rxn):
            k_r = rates[r]
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
            dinel = dinel + contrib * slopes[r] * inv_Te
        ex_energy = self.ex[2]
        ex_contrib = (ne * rates[-1]) * nn * ex_energy
        inelastic = inelastic + ex_contrib
        dinel = torch.clamp(dinel + ex_contrib * slopes[-1] * inv_Te, min=0.0)
        for z in range(Z):
            d_mom[z] = d_mom[z] + zq[z] * E * ni[z] * E_z
        if g.solve_plume:
            for z in range(Z):
                d_mom[z] = d_mom[z] + rho_i[z] * (a_i * a_i) * pre["dlnA"]
        if g.ion_wall_losses:
            sqrt_te = torch.sqrt(E * Te / mi)
            for z in range(Z):
                nu_iw = float(0.6 * np.sqrt(zq[z]) / g.gap) * sqrt_te * in_channel
                d_rho[z] = d_rho[z] - nu_iw * rho_i[z]
                d_mom[z] = d_mom[z] - nu_iw * mom_i[z]
                d_rho_n = d_rho_n + g.wall_recycling * (nu_iw * rho_i[z])

        upd = lambda base, flux, src: base + (-dt) * ddz(flux) * interior_f + dt * src * interior_f
        rho_n_new = torch.clamp(upd(rho_n_b, Fn, d_rho_n), min=rho_floor)
        rho_n2_new = torch.clamp(upd(rho_n2_b, Fn2, d_rho_n2), min=rho_floor) if G == 2 else None
        rho_new = [torch.clamp(upd(rho_b[z], Fr[z], d_rho[z]), min=rho_floor) for z in range(Z)]
        mom_new = [upd(mom_b[z], Fm[z], d_mom[z]) for z in range(Z)]

        # electron energy: backward Euler in Te, a tridiagonal system by cyclic reduction
        ne_new = rho_new[0] * (inv_mi * zq[0])
        for z in range(1, Z):
            ne_new = ne_new + rho_new[z] * (zq[z] * inv_mi)
        ne_new = torch.clamp(ne_new, min=g.ne_floor)
        Gamma_e = (j_i - j_d_loc) * (1.0 / E)
        G_f = 0.5 * (Gamma_e + _roll(Gamma_e, -1))
        kap = (10.0 / 9.0) * mu * ne * Te
        kf = (0.5 * inv_dz) * (kap + _roll(kap, -1))
        Gp, Gn = 2.5 * torch.clamp(G_f, min=0.0), 2.5 * torch.clamp(G_f, max=0.0)
        nu_eps = self.wall_energy_loss(Te, ne, in_channel, c_w, lnTe, rs_te)
        q_ohm = (j_d_loc - j_i) * E_z * (1.0 / E)
        Gp_m, Gn_m, kf_m = _roll(Gp, 1), _roll(Gn, 1), _roll(kf, 1)
        if g.solve_plume:
            wp, wm = pre["wp"], pre["wm"]
            sub = (-Gp_m - kf_m) * wm * inv_dz
            sup = (Gn - kf) * wp * inv_dz
            diag = ne_new * (1.5 * inv_dt + nu_eps * 1.5) + ((Gp + kf) * wp + (kf_m - Gn_m) * wm) * inv_dz
        else:
            sub = (-Gp_m - kf_m) * inv_dz
            sup = (Gn - kf) * inv_dz
            diag = ne_new * (1.5 * inv_dt + nu_eps * 1.5) + (Gp - Gn_m + kf + kf_m) * inv_dz
        rhs = nE * inv_dt + q_ohm - inelastic
        diag = diag + dinel
        rhs = rhs + dinel * Te
        Te_bc_l = torch.full_like(dV, g.anode_Te)
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
            b_new = 1.0 - a * cm - c * ap
            d = d - a * _roll(d, k) - c * _roll(d, -k)
            rb = 1.0 / b_new
            d = d * rb
            if lvl < n_levels - 1:
                a = -a * _roll(a, k) * rb
                c = -c * _roll(c, -k) * rb
            k *= 2
        Te_new = torch.where(lane == 0, Te_bc_l, d)
        Te_new = torch.clamp(torch.where(lane >= NC - 1, te_cath, Te_new), g.Te_min, g.Te_max)
        return (rho_n_new, 1.5 * ne_new * Te_new, rho_new, mom_new, rho_n2_new), (j_d, Te, ne, E_z, nn)


class Discharge:
    """The time loop of one call: state, running sums and the I_d(t) trace as
    tensors that each step rewrites in place (so that a CUDA graph can replay it)."""

    def __init__(self, params: dict, base_B: torch.Tensor, g: Grid, dtype: torch.dtype):
        self.g, self.dtype, self.physics = g, dtype, Physics(g, dtype)
        dev = params["V_d"].device
        B, NC, Z, LN = params["V_d"].shape[0], g.nc, g.ncharge, g.lanes
        self.params, self.base_B = params, base_B
        z = torch.as_tensor(g.cell_centers(), dtype=torch.float32, device=dev)
        omega = E * (base_B[None, :] * params["B_hat"][:, None]) / ME
        nu_anom = anomalous_profile(params, z, g) * omega
        pad = lambda x: torch.nn.functional.pad(x, (0, LN - NC)).to(dtype)
        self.nu_anom, self.omega = pad(nu_anom), pad(omega)
        mdot_in = params["mdot_a"] + ingestion(params["P_b"], params["f_n"], g)
        col = lambda x: x[:, None].to(dtype)
        self.dV, self.mdot_in = col(params["V_d"] - params["V_cc"]), col(mdot_in)
        self.u_n, self.c_w = col(torch.clamp(params["u_n"], min=10.0)), col(params["c_w"])
        self.te_cath, self.tan_div = col(params["T_e_cath"]), col(params["tan_div"])
        self.rc, self.l_dt = col(params["circuit_R"]), col(params["circuit_L"] * (1.0 / g.dt))
        self.pre = self.physics.invariants(self.c_w, self.tan_div)
        self._init_state(mdot_in, dev)
        self.sums = torch.zeros((B, 6), dtype=dtype, device=dev)  # thrust, I_d, -, I_B0, mdot_ion, u_exit
        self.prof = torch.zeros((Z + 4, B, LN), dtype=dtype, device=dev)
        self.failed = torch.zeros(B, dtype=torch.bool, device=dev)
        self.i_d = (E / g.mi) * params["mdot_a"].to(dtype)
        self.icir = self.i_d[:, None].clone()

    def _init_state(self, mdot_in, dev):
        g, p = self.g, self.params
        B, NC, Z, LN, mi = p["V_d"].shape[0], g.nc, g.ncharge, g.lanes, g.mi
        z = torch.as_tensor(g.cell_centers(), dtype=torch.float32, device=dev)
        z_ch, L = g.channel_length, g.domain[1] - g.domain[0]
        u_n = torch.clamp(p["u_n"], min=10.0)
        dV = (p["V_d"] - p["V_cc"])[:, None]
        n_prof = 2e17 + 1e18 * torch.exp(-(((z - z_ch) / (0.3 * z_ch)) ** 2))
        frac = torch.clamp((z - 0.5 * z_ch) / (L - 0.5 * z_ch), 0.0, 1.0)[None, :]
        u0 = -float(np.sqrt(E * 3.0 / mi)) * (1.0 - frac) + torch.sqrt(
            2.0 * E * torch.clamp(dV, min=50.0) / mi) * frac**2
        Te0 = 3.0 + 0.04 * torch.clamp(dV, min=50.0) * torch.exp(-(((z - z_ch) / (0.4 * z_ch)) ** 2))[None, :]
        full = lambda: torch.zeros((B, LN), dtype=torch.float32, device=dev)
        if g.neutral_groups == 2:
            fr = g.fast_neutral_fraction
            rn = ((1.0 - fr) * mdot_in / (g.area * g.slow_neutral_ratio * u_n))[:, None]
            rn2 = full()
            rn2[:, :NC] = (fr * mdot_in / (g.area * g.fast_neutral_ratio * u_n))[:, None]
        else:
            rn = (mdot_in / (g.area * u_n))[:, None]
        rho_n, nE, ne0 = full(), full(), torch.zeros((B, NC), dtype=torch.float32, device=dev)
        rho_n[:, :NC] = rn
        rho_i, mom_i = [], []
        for zi in range(Z):
            r = torch.broadcast_to(n_prof * mi * (0.25**zi), (B, NC))
            ri, mo = full(), full()
            ri[:, :NC], mo[:, :NC] = r, r * u0
            rho_i.append(ri)
            mom_i.append(mo)
            ne0 = ne0 + (zi + 1) * r / mi
        nE[:, :NC] = 1.5 * ne0 * Te0
        # the range scrub of the state, as the solver applies it on entry
        floor, ceil = float(1e10 * mi), 1e21 * mi
        sane = lambda x, lo, hi: torch.clamp(torch.where(torch.isfinite(x), x, lo), lo, hi)
        rho_i = [sane(r, floor, ceil) for r in rho_i]
        mom_i = [torch.clamp(torch.where(torch.isfinite(m), m, 0.0), -r * 3e5, r * 3e5) for m, r in zip(mom_i, rho_i)]
        cast = lambda x: x.to(self.dtype)
        self.rho_n, self.nE = cast(sane(rho_n, floor, ceil)), cast(sane(nE, 1.0, 1e23))
        self.rho_i, self.mom_i = [cast(r) for r in rho_i], [cast(m) for m in mom_i]
        self.rho_n2 = cast(sane(rn2, floor, ceil)) if g.neutral_groups == 2 else None
        self.u_i = [m / torch.clamp(r, min=floor) for m, r in zip(self.mom_i, self.rho_i)]

    def step(self, accumulate: bool) -> None:
        """One timestep in place; with ``accumulate`` its values join the running sums."""
        g, Z = self.g, self.g.ncharge
        floor, exit_ix, A_ch = float(1e10 * g.mi), g.nc - 2, g.area
        (rho_n, nE, rho_i, mom_i, rho_n2), (j_d, Te, ne, E_z, nn) = self.physics(
            self.rho_n, self.nE, self.rho_i, self.mom_i, self.u_i, self.nu_anom, self.omega, self.dV,
            self.mdot_in, self.u_n, self.c_w, self.te_cath, self.rc, self.l_dt, self.icir, self.pre, self.rho_n2)
        u_i = [mom_i[z] / torch.clamp(rho_i[z], min=floor) for z in range(Z)]
        for dst, src in zip([self.rho_n, self.nE, *self.rho_i, *self.mom_i, *self.u_i],
                            [rho_n, nE, *rho_i, *mom_i, *u_i]):
            dst.copy_(src)
        if rho_n2 is not None:
            self.rho_n2.copy_(rho_n2)
        i_d = j_d[:, 0] * A_ch
        if accumulate:
            a_i2 = 1.380649e-23 * g.ion_temp_K / g.mi
            thrust = beam = mdot_ion = 0.0
            for z in range(Z):
                r_ex, m_ex, u_ex = rho_i[z][:, exit_ix], mom_i[z][:, exit_ix], u_i[z][:, exit_ix]
                thrust = thrust + A_ch * (m_ex * u_ex + r_ex * a_i2)
                beam = beam + (A_ch * E * (z + 1) / g.mi) * r_ex * u_ex
                mdot_ion = mdot_ion + A_ch * m_ex
                self.prof[z] += u_i[z]
            if g.solve_plume:
                thrust = thrust * self.pre["qs_t"][:, 0]
                beam = beam * self.pre["qs_f"][:, 0]
                mdot_ion = mdot_ion * self.pre["qs_f"][:, 0]
            for off, val in enumerate((Te, ne, E_z, nn)):
                self.prof[Z + off] += val
            for j, val in ((0, thrust), (1, i_d), (3, beam), (4, mdot_ion), (5, u_i[0][:, exit_ix])):
                self.sums[:, j] += val
        self.failed |= ~torch.isfinite(i_d)
        self.icir.copy_(i_d[:, None])
        self.i_d.copy_(i_d)

    def run(self) -> dict:
        """Every step of the call, then the time averages and the efficiencies."""
        g = self.g
        trace = torch.zeros((self.i_d.shape[0], max(g.num_save, 1)), dtype=self.dtype, device=self.i_d.device)
        stride = max(1, g.num_steps // g.num_save) if g.num_save else 0
        steps = self._steppers()
        for i in range(g.num_steps):
            steps[i >= g.avg_start_step]()
            if stride and i % stride == 0 and i // stride < g.num_save:
                trace[:, i // stride] = self.i_d
        state = [self.rho_n, self.nE, *self.rho_i, *self.mom_i] + ([self.rho_n2] if self.rho_n2 is not None else [])
        self.failed |= ~torch.stack([torch.isfinite(s).all(dim=1) for s in state]).all(dim=0)
        return self._finalize(trace, stride)

    def _steppers(self):
        if self.i_d.device.type != "cuda":
            return [lambda: self.step(False), lambda: self.step(True)]
        # warm up on a side stream, restore the state, then capture one step of each kind
        keep = [t.clone() for t in self._buffers()]
        side = torch.cuda.Stream(self.i_d.device)
        side.wait_stream(torch.cuda.current_stream(self.i_d.device))
        graphs = []
        with torch.cuda.stream(side):
            self.step(True)
            self.step(False)
            for t, v in zip(self._buffers(), keep):
                t.copy_(v)
            side.synchronize()
            for acc in (False, True):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    self.step(acc)
                graphs.append(graph)
        torch.cuda.current_stream(self.i_d.device).wait_stream(side)
        for t, v in zip(self._buffers(), keep):  # capture does not run the steps; restore anyway
            t.copy_(v)
        return [g.replay for g in graphs]

    def _buffers(self) -> list:
        extra = [self.rho_n2] if self.rho_n2 is not None else []
        return [self.rho_n, self.nE, *self.rho_i, *self.mom_i, *self.u_i, *extra, self.sums, self.prof,
                self.failed, self.icir, self.i_d]

    def _finalize(self, trace, stride) -> dict:
        g, p = self.g, self.params
        f32 = lambda x: x.to(torch.float32)
        n_avg = float(max(g.num_steps - g.avg_start_step, 1))
        fail = self.failed
        avg = lambda v: torch.where(fail.reshape((-1,) + (1,) * (v.ndim - 1)), torch.nan, f32(v) / n_avg)
        thrust, I_d, I_B0 = avg(self.sums[:, 0]), avg(self.sums[:, 1]), avg(self.sums[:, 3])
        u_exit = avg(self.sums[:, 5])
        out = {"T": thrust, "I_d": I_d, "I_B0": I_B0, "eta_c": I_B0 / I_d,
               "eta_m": avg(self.sums[:, 4]) / p["mdot_a"],
               "eta_v": u_exit**2 * g.mi / (2 * E * torch.clamp(p["V_d"], min=1.0)),
               "eta_a": thrust**2 / (2 * p["mdot_a"] * torch.clamp(I_d * p["V_d"], min=1e-6)),
               "u_ion": avg(self.prof[0])[:, : g.nc]}
        if g.num_save:
            out["discharge_current_trace"] = torch.where(fail[:, None], torch.nan, f32(trace))
        if g.num_save and g.cycle_average:
            # the efficiencies keep the window mean; the reported current is the cycle mean
            save_idx = torch.arange(g.num_save, device=trace.device) * stride
            times = (save_idx.float() + 1.0) * g.dt
            i_cyc = cycle_average(out["discharge_current_trace"], times, g.average_start_time)
            out["I_d"] = torch.where(torch.isfinite(i_cyc), i_cyc, I_d)
        return out


def cycle_average(x, times, t_start: float):
    """Mean of an I_d(t) trace between the first and last upward crossings of
    its window mean (a whole number of breathing cycles), else the window mean."""
    t = torch.broadcast_to(times, x.shape)
    w = (t >= t_start).to(x.dtype)
    win_mean = torch.sum(x * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)
    d = x - win_mean[..., None]
    up = (d[..., :-1] <= 0) & (d[..., 1:] > 0) & (w[..., :-1] > 0) & (w[..., 1:] > 0)
    n = x.shape[-1]
    idx = torch.arange(n - 1, device=x.device)
    first = torch.amin(torch.where(up, idx, n + 1), dim=-1) + 1
    last = torch.amax(torch.where(up, idx, -1), dim=-1) + 1
    j = torch.arange(n, device=x.device)
    cw = ((j >= first[..., None]) & (j < last[..., None])).to(x.dtype)
    cyc_mean = torch.sum(x * cw, dim=-1) / torch.clamp(torch.sum(cw, dim=-1), min=1.0)
    return torch.where(torch.sum(up, dim=-1) >= 2, cyc_mean, win_mean)


def guards(out: dict, mdot_a, g: Grid) -> dict:
    """The thruster component's guards: a row whose thrust, beam or discharge
    current or mass efficiency is negative, whose beam current passes
    1.5 Z e mdot / m_i, or whose thrust is not finite is NaN (float64)."""
    i_eq = E * mdot_a.to(torch.float64) / g.mi
    bad = (out["T"] < 0) | (out["I_B0"] < 0) | (out["I_d"] < 0) | (out["eta_m"] < 0)
    bad = bad | (out["I_B0"] > 1.5 * g.ncharge * i_eq) | ~torch.isfinite(out["T"])
    if g.average_start_time >= 2e-4:
        bad = bad | (out["I_d"] < 0.2 * i_eq) | (out["I_d"] > 8.0 * i_eq)
    return {k: torch.where(bad.reshape((-1,) + (1,) * (v.ndim - 1)), torch.nan, v.to(torch.float64))
            for k, v in out.items()}


# --------------------------------------------------------------------------- cathode
def cathode(rows: dict, dtype) -> dict:
    """Cathode coupling voltage, Jorns (2021), clamped to [0, V_a]."""
    c = lambda k: rows[k].to(dtype)
    pb, pt, ps = c("P_b") * TORR_2_PA, c("P_T") * TORR_2_PA, c("Pstar") * TORR_2_PA
    v = c("V_vac") + c("T_e") * torch.log1p(pb / pt) - (c("T_e") / (pt + ps)) * pb
    return {"V_cc": torch.clamp(v, min=torch.zeros_like(c("V_a")), max=c("V_a"))}


# ----------------------------------------------------------------------------- plume
def _weideman(N: int = 36):
    M = 2 * N
    k = np.arange(-M + 1, M)
    L = np.sqrt(N / np.sqrt(2.0))
    t = L * np.tan(k * np.pi / M / 2.0)
    f = np.concatenate([[0.0], np.exp(-(t**2)) * (L**2 + t**2)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2 * M)
    return float(L), np.flipud(a[1 : N + 1])


_WL, _WA = _weideman()


def _wofz(x, y):
    """(Re, Im) of the Faddeeva function w(x + iy), y >= 0 (Weideman 1994)."""
    dr, di = _WL + y, -x
    d2 = dr * dr + di * di
    nr, ni = _WL - y, x
    zr, zi = (nr * dr + ni * di) / d2, (ni * dr - nr * di) / d2
    pr, pi = torch.zeros_like(zr), torch.zeros_like(zi)
    for coeff in _WA:
        pr, pi = pr * zr - pi * zi + float(coeff), pr * zi + pi * zr
    d2r, d2i = dr * dr - di * di, 2.0 * dr * di
    d2n = d2r * d2r + d2i * d2i
    inv_sqrt_pi = float(1.0 / np.sqrt(np.pi))
    return (2.0 * (pr * d2r + pi * d2i) / d2n + inv_sqrt_pi * dr / d2,
            2.0 * (pi * d2r - pr * d2i) / d2n + inv_sqrt_pi * (-di) / d2)


def _gaussian_norm(alpha):
    a = alpha / 2.0
    b = torch.full_like(alpha, np.pi) / (2.0 * alpha)
    dawson = float(np.sqrt(np.pi) / 2.0) * _wofz(torch.abs(a), torch.zeros_like(a))[1] * torch.sign(a)
    wr, wi = _wofz(a, b)
    re_erfi = torch.exp(-(b**2)) * (wi * torch.cos(2.0 * a * b) + wr * torch.sin(2.0 * a * b))
    return float(np.pi**1.5 / 2.0) * alpha * (2.0 * (float(2.0 / np.sqrt(np.pi)) * dawson - re_erfi))


def _simpson_weights(x: np.ndarray) -> np.ndarray:
    n, w = x.size, np.zeros(x.size)
    for i0 in range(0, n - 2, 2):
        h0, h1 = x[i0 + 1] - x[i0], x[i0 + 2] - x[i0 + 1]
        s = h0 + h1
        w[i0] += s / 6.0 * (2.0 - h1 / h0)
        w[i0 + 1] += s / 6.0 * s**2 / (h0 * h1)
        w[i0 + 2] += s / 6.0 * (2.0 - h0 / h1)
    return w


PLUME_ANGLES = 91
_ANGLES = np.linspace(0.0, np.pi / 2, PLUME_ANGLES)  # 91 points: an odd count, whole Simpson blocks
_SIMPSON = _simpson_weights(_ANGLES)


def plume(rows: dict, I_B0, radius: float, dtype) -> dict:
    """Two-Gaussian beam plus charge-exchange wing over 0-90 degrees at ``radius``."""
    c = lambda k: rows[k].to(dtype)
    P = c("P_b") * TORR_2_PA
    I_B0 = I_B0.to(dtype)
    ang = torch.as_tensor(_ANGLES, dtype=dtype, device=P.device)
    n = c("c4") * P + c("c5")
    alpha1 = torch.clamp(c("c2") * P + c("c3"), max=np.pi / 2)
    valid = alpha1 > 0
    alpha1 = torch.where(valid, alpha1, 0.1)
    alpha2 = alpha1 / c("c1")
    A1, A2 = (1 - c("c0")) / _gaussian_norm(alpha1), c("c0") / _gaussian_norm(alpha2)
    ex = lambda x: x[..., None]
    decay = torch.exp(-radius * ex(n) * ex(c("sigma_cex")))
    j_cex = ex(I_B0) * (1 - decay) / (2 * np.pi * radius**2)
    base = ex(I_B0) * decay / radius**2
    j_beam = base * ex(A1) * torch.exp(-((ang / ex(alpha1)) ** 2))
    j_scat = base * ex(A2) * torch.exp(-((ang / ex(alpha2)) ** 2))
    j_ion = j_beam + j_scat + j_cex
    j_ion = torch.where((valid & torch.all(j_ion > 0, dim=-1))[..., None], j_ion, 1e-20)
    w = torch.as_tensor(_SIMPSON, dtype=dtype, device=P.device)
    flip = torch.flip(j_beam + j_scat, dims=(-1,))
    den = flip * torch.cos(ang)
    cos_div = torch.sum(den * torch.sin(ang) * w, dim=-1) / torch.sum(den * w, dim=-1)
    cos_div = torch.where(torch.isfinite(cos_div), cos_div, torch.nan)
    return {"j_ion": j_ion, "div_angle": torch.arccos(torch.clamp(cos_div, -1.0, 1.0))}


# ---------------------------------------------------------------------------- system
def _component(doc: dict, name: str) -> dict:
    return next(c for c in doc["components"] if c["name"] == name)


def fidelity(doc: dict, use_model: str) -> tuple:
    """The Thruster's model fidelity for ``use_model`` ("best" or "worst")."""
    text = str(_component(doc, "Thruster").get("model_fidelity", "(2, 2)"))
    alpha = tuple(int(t) for t in text.strip("()[] ").split(",") if t.strip())
    return tuple(0 for _ in alpha) if use_model == "worst" else alpha


def _tensors(rows: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in rows.items()}


def _thruster_config(doc: dict, t: dict, dtype=torch.float32) -> dict:
    """The Thruster's input ``config`` for the rows ``t`` (tensors), with the
    coupling voltage the cathode gives in ``dtype``, as float32."""
    thr = _component(doc, "Thruster")
    names = [v["name"] for v in thr["inputs"] if v["name"] != "V_cc"]
    rows = {**{k: t[k] for k in names}, "V_cc": cathode(t, dtype)["V_cc"].to(torch.float32)}
    return input_config(thr, rows)


def grid_for(doc: dict, rows: dict, use_model: str) -> Grid:
    """The grid (cells, time step, steps) of one call on ``rows``: the time
    step follows the call's largest anode voltage and smallest coupling voltage."""
    t = _tensors(rows, "cpu")
    return make_grid(_component(doc, "Thruster"), fidelity(doc, use_model), _thruster_config(doc, t))


def discharge(doc: dict, rows: dict, use_model: str, dtype, device, lanes: int = 0,
              batch: dict | None = None) -> "Discharge":
    """The discharge solve of ``rows`` (name -> array), set up on ``device`` in
    ``dtype``, on the grid of the whole call ``batch`` (default: ``rows``)."""
    from dataclasses import replace

    g = replace(grid_for(doc, rows if batch is None else batch, use_model), lane_count=lanes)
    config = _thruster_config(doc, _tensors(rows, device), dtype)
    params = solver_params(config, next(iter(rows.values())).shape[0], device)
    base_B = bfield(g, _component(doc, "Thruster").get("thruster", "SPT-100")).to(device)
    return Discharge(params, base_B, g, dtype)


def predict(doc: dict, rows: dict, use_model: str, dtype=torch.float32, device="cpu",
            batch: dict | None = None) -> dict:
    """Every compared output of the coupled system for ``rows`` (name -> float32
    array (n,)), as float64 numpy arrays; ``doc`` is the configuration file and
    ``batch`` the whole call the rows belong to (its grid is theirs)."""
    t = _tensors(rows, device)
    out = cathode(t, dtype)
    d = discharge(doc, rows, use_model, dtype, device, batch=batch)
    out.update(guards(d.run(), t["mdot_a"], d.g))
    out.update(plume(t, out["I_B0"], float(_component(doc, "Plume").get("sweep_radius", 1.0)), dtype))
    return {k: v.to(torch.float64).cpu().numpy() for k, v in out.items()}
