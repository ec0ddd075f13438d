"""Thruster component of the port: the reference-format wrapper around the
batched 1-D Hall discharge solver (the JAX package's ``models/thruster/__init__.py``).

``run_simulation`` takes a HallThruster.jl-format input tree
(``{'config': ..., 'simulation': ..., 'postprocess': ...}``) and returns the
output tree; ``hallthruster_jl`` is the PEM component around it, with the
NaN-row failure masks. One call solves a whole batch: any config value may be a
(batch,) tensor. Both run on a CUDA device unless the caller passes
``device="cpu"``. :func:`dispatch_solver` picks the solver from the config: the
K-step CUDA kernel on a CUDA device, its plain PyTorch version on the CPU
(:mod:`.fused_step`), and past 254 cells or in float64 the lax solver
(:mod:`.solver`) on either. :func:`simulate_batch_sharded` runs the same
dispatch on every shard of a device mesh.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hallthrusterpem_tpu_torch.constants import FUNDAMENTAL_CHARGE, atomic_mass_kg
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
from hallthrusterpem_tpu_torch.models.thruster import solver
from hallthrusterpem_tpu_torch.models.thruster.config import Geometry, SolverConfig, make_params
from hallthrusterpem_tpu_torch.models.thruster.mapping import (
    PEM_TO_JULIA,
    _extreme,
    convert_to_pem,
    default_model_fidelity,
    format_input_tree,
)
from hallthrusterpem_tpu_torch.models.thruster.postprocess import cycle_averaged_current
from hallthrusterpem_tpu_torch.ops.interp import interp1d
from hallthrusterpem_tpu_torch.utils import resolve_device

#: the component's data-exchange type: name -> tensor
Dataset = Dict[str, torch.Tensor]

__all__ = ["hallthruster_jl", "run_simulation", "run_hallthruster_jl", "simulate_batch_sharded",
           "PEM_TO_JULIA", "SolverConfig", "Dataset"]


def _load_bfield(thr: dict, cfg: SolverConfig) -> np.ndarray:
    """Magnetic-field profile [T] on the solver's cell centres (float32) from a
    device dict. A named field file is interpolated in float32 as the JAX package
    does, and raises if it is missing; a device that names no file gets the JAX
    package's representative SPT-100-class profile (~200 G peak at the channel
    exit, ~12 mm decay into the plume)."""
    z_cells = cfg.cell_centers()
    file = (thr or {}).get("magnetic_field", {}).get("file")
    if not file:
        z_ch = cfg.geometry.channel_length
        s = np.where(z_cells < z_ch, 0.011, 0.012)
        return (0.020 * np.exp(-0.5 * ((z_cells - z_ch) / s) ** 2)).astype(np.float32)
    if not Path(str(file)).exists():
        raise FileNotFoundError(f"magnetic-field file of the device not found: {file!r}")
    raw = np.genfromtxt(str(file), delimiter=",", skip_header=1)
    if raw.ndim == 1 or raw.shape[1] < 2:  # maybe headerless
        raw = np.genfromtxt(str(file), delimiter=",")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return interp1d(f32(z_cells), f32(raw[:, 0]), f32(raw[:, 1])).numpy()


def _tree_to_solver_inputs(tree: dict, device=None):
    """Split an input tree into (static SolverConfig, per-sample params on
    ``device``, base B-field tensor on ``device``)."""
    device = resolve_device(device)
    config = tree.get("config", {})
    sim = tree.get("simulation", {})
    post = tree.get("postprocess", {})
    thr = config.get("thruster", {}) or {}

    geom_d = thr.get("geometry", {})
    geometry = Geometry(
        channel_length=float(geom_d.get("channel_length", 0.025)),
        inner_radius=float(geom_d.get("inner_radius", 0.0345)),
        outer_radius=float(geom_d.get("outer_radius", 0.05)),
    )
    domain = config.get("domain", (0.0, 0.08))
    duration = float(sim.get("duration", 1e-3))

    anom = config.get("anom_model", {}) or {}
    shift = "none"
    inner = anom
    if anom.get("type") in ("LogisticPressureShift", "SimpleLogisticShift"):
        shift = anom["type"]
        inner = anom.get("model", {}) or {}
    anom_type = inner.get("type", "TwoZoneBohm")

    num_cells = int(sim.get("grid", {}).get("num_cells", 100))
    ncharge = int(config.get("ncharge", 1))
    dt = _extreme(sim.get("dt", 5e-9), largest=False)
    if sim.get("adaptive"):
        # quasi-static adaptive stepping: the CFL-consistent dt of this grid (the
        # bound default_model_fidelity applies), clamped to [min_dt, max_dt]; the
        # tree's dt is then only the initial guess it is in HallThruster.jl
        fid = default_model_fidelity((0, ncharge - 1), {"config": config})
        dx = (float(domain[1]) - float(domain[0])) / (num_cells + 1)
        dt_cfl = fid["dt"] * dx / (float(domain[1]) / (fid["num_cells"] + 1))
        dt = float(np.clip(dt_cfl, float(sim.get("min_dt", dt_cfl)), float(sim.get("max_dt", dt_cfl))))

    # three-region anomalous-profile shape constants, overridable per config
    shape_keys = {k: float(config[k]) for k in
                  ("anode_alpha", "anode_edge_frac", "anode_edge_width", "anom_barrier_width",
                   "wall_recycling")
                  if config.get(k) is not None}

    cfg = SolverConfig(
        num_cells=num_cells,
        ncharge=ncharge,
        domain=(float(domain[0]), float(domain[1])),
        geometry=geometry,
        **shape_keys,
        propellant=str(config.get("propellant", "Xenon")),
        dt=dt,
        duration=duration,
        average_start_time=float(post.get("average_start_time", 0.5 * duration)),
        anom_model=anom_type,
        pressure_shift=shift,
        ion_wall_losses=bool(config.get("ion_wall_losses", True)),
        solve_plume=bool(config.get("solve_plume", False)),
        neutral_groups=int(config.get("neutral_groups", 1)),
        apply_thrust_divergence_correction=bool(config.get("apply_thrust_divergence_correction", False)),
        num_save=int(sim.get("num_save", 0)),
    )

    overrides = {}

    def grab(name, *path):
        node = config
        for key in path[:-1]:
            node = node.get(key, {}) if isinstance(node, dict) else {}
        val = node.get(path[-1]) if isinstance(node, dict) else None
        if val is not None:
            overrides[name] = val

    grab("V_d", "discharge_voltage")
    grab("V_cc", "cathode_coupling_voltage")
    grab("mdot_a", "anode_mass_flow_rate")
    grab("P_b", "background_pressure_Torr")
    grab("T_e_cath", "cathode_Tev")
    grab("u_n", "neutral_velocity")
    grab("l_t", "transition_length")
    grab("f_n", "neutral_ingestion_multiplier")
    grab("B_hat", "magnetic_field_scale")
    grab("tan_div", "plume_divergence_tan")
    grab("circuit_R", "circuit", "R")
    grab("circuit_L", "circuit", "L")
    wl = config.get("wall_loss_model", {}) or {}
    if wl.get("loss_scale") is not None:
        overrides["c_w"] = wl["loss_scale"]
    for src, dst in (("c1", "a1"), ("c2", "a2"), ("hall_min", "hall_min"),
                     ("hall_max", "hall_max"), ("center", "center"), ("width", "width"),
                     ("barrier_scale", "anom_depth"), ("barrier_width", "anom_width")):
        if inner.get(src) is not None:
            overrides[dst] = inner[src]
    for src, dst in (("dz", "shift_dz"), ("z0", "shift_z0"), ("pstar", "shift_pstar"),
                     ("alpha", "shift_alpha"), ("shift_length", "shift_dz")):
        if anom.get(src) is not None:
            overrides[dst] = anom[src]

    params = make_params(overrides, device=device)
    base_B = torch.as_tensor(_load_bfield(thr, cfg), device=device)
    return cfg, params, base_B


def uses_lax_solver(cfg: SolverConfig) -> bool:
    """Whether a config needs the lax solver: a grid wider than the K-step
    kernel's 256-lane layout (past 254 cells), or a dtype other than float32."""
    return cfg.nc > fs.LANES - 2 or cfg.dtype != "float32"


def dispatch_solver(params: dict, base_B, cfg: SolverConfig, chunk_steps: int = 0) -> dict:
    """Run the discharge solve where ``params`` lie. Float32 configs of at most 254
    cells run the K-step time loop: the CUDA kernel on a CUDA device, its plain
    version on the CPU. Finer grids and other dtypes run the lax solver
    (:mod:`.solver`) on the same device, in segments of ``chunk_steps`` steps
    when the caller asks for them (0: one segment; a run with an I_d(t) trace is
    never split, as in the JAX package). The kernel path ignores ``chunk_steps``."""
    if not uses_lax_solver(cfg):
        return fs.simulate_batch_multi(params, base_B, cfg)
    if chunk_steps and cfg.num_steps > chunk_steps and cfg.num_save == 0:
        return solver.simulate_batch_chunked(params, base_B, cfg, chunk_steps=chunk_steps)
    return solver.simulate_batch(params, base_B, cfg)


def simulate_batch_sharded(params: dict, base_B, cfg: SolverConfig, mesh, axis_name: str = "batch",
                           chunk_steps: int = 0) -> dict:
    """Run the discharge solve over a device mesh, batch axis sharded (the
    counterpart of the JAX package's multi-chip path).

    Each shard runs :func:`dispatch_solver` on its own device: the K-step kernel
    per shard on CUDA, its plain version on the CPU, the lax solver past 254
    cells or in float64. The solve has no traffic between samples, so the
    outputs, concatenated in batch order on ``mesh.devices[0]``, are those of
    the unsharded run. JAX's ``backend`` and ``interpret`` arguments have no
    counterpart: the dispatcher picks the solver from ``cfg`` and the device.
    ``cfg`` is the whole batch's (its ``dt`` is the smallest over the batch), so
    every shard steps alike; ``base_B`` is copied to each device.

    :param params: per-sample parameter dict; every leaf ``(B, ...)`` with B a
        multiple of the mesh's ``axis_name`` size (else ``ValueError``)
    :param mesh: a :class:`~hallthrusterpem_tpu_torch.parallel.mesh.Mesh`
    """
    from hallthrusterpem_tpu_torch.parallel.mesh import sharded_call

    solve = lambda p, b: dispatch_solver(p, b, cfg, chunk_steps=chunk_steps)
    return sharded_call(solve, mesh, axis_name)(params, torch.as_tensor(base_B, dtype=torch.float32))


def _solve_on_mesh(params: dict, base_B, cfg: SolverConfig, mesh) -> dict:
    """:func:`simulate_batch_sharded` with one config for the whole batch: the
    rows are padded to a multiple of the mesh with copies of the last row, and
    the padding is dropped from the outputs."""
    n = params["V_d"].shape[0]
    rem = (-n) % mesh.n_devices
    if rem:
        params = {k: torch.cat([v, v[-1:].expand(rem, *v.shape[1:])]) for k, v in params.items()}
    raw = simulate_batch_sharded(params, base_B, cfg, mesh)
    return {k: v[:n] if rem and v.ndim and v.shape[0] == n + rem else v for k, v in raw.items()}


def run_simulation(json_input, device=None, mesh=None, **_compat) -> dict:
    """Run the discharge solver from a reference-format input tree (or the path of
    its JSON file) and return the reference-format output tree
    (``{'output': {'average': ...}, 'config': ..., ...}``) with tensors on
    ``device``. With ``simulation.num_save`` the average holds the I_d(t) trace,
    and ``postprocess.cycle_average`` then replaces ``discharge_current`` by its
    whole-breathing-cycle mean where that is finite. With a ``mesh``
    (:class:`~hallthrusterpem_tpu_torch.parallel.mesh.Mesh`) the batch is
    sharded over its devices, every shard stepped with the one config the
    whole tree gives."""
    if not isinstance(json_input, dict):
        with open(json_input, "r", encoding="utf-8") as fd:
            json_input = json.load(fd)

    cfg, params, base_B = _tree_to_solver_inputs(json_input, device)
    scalar_in = params["V_d"].ndim == 0
    if scalar_in:
        params = {k: v.reshape(1) for k, v in params.items()}
    raw = dispatch_solver(params, base_B, cfg) if mesh is None else _solve_on_mesh(params, base_B, cfg, mesh)
    if scalar_in:
        raw = {k: v[0] for k, v in raw.items()}
    z_axis = 0 if scalar_in else 1

    average = {
        "thrust": raw["thrust"],
        "discharge_current": raw["discharge_current"],
        "discharge_current_std": raw["discharge_current_std"],
        "ion_current": raw["ion_current"],
        "current_eff": raw["current_eff"],
        "mass_eff": raw["mass_eff"],
        "voltage_eff": raw["voltage_eff"],
        "anode_eff": raw["anode_eff"],
        # ui[Z] is the (batch, NC) velocity profile of charge state Z+1
        "ui": [raw["ui"].select(z_axis, zi) for zi in range(cfg.ncharge)],
        "z": raw["z"],
        "nu_anom": raw["nu_anom"],
        "B": raw["B"],
        "Tev": raw["Tev"],
        "ne": raw["ne"],
        "nn": raw["nn"],
        "potential": raw["potential"],
        "E": raw["E"],
    }
    if "discharge_current_trace" in raw:
        average["discharge_current_trace"] = raw["discharge_current_trace"]
        average["trace_times"] = raw["trace_times"]
        if json_input.get("postprocess", {}).get("cycle_average"):
            i_cyc = cycle_averaged_current(raw["discharge_current_trace"], raw["trace_times"],
                                           cfg.average_start_time)
            average["discharge_current"] = torch.where(
                torch.isfinite(i_cyc), i_cyc, average["discharge_current"])
    output_tree = {
        "output": {"average": average},
        "config": json_input.get("config", {}),
        "simulation": json_input.get("simulation", {}),
        "postprocess": json_input.get("postprocess", {}),
    }
    if out_file := json_input.get("postprocess", {}).get("output_file"):
        _write_output_json(out_file, output_tree)
    return output_tree


#: the reference wrapper's name for :func:`run_simulation`
run_hallthruster_jl = run_simulation


def _write_output_json(path, tree: dict) -> None:
    def _tolist(x):
        if isinstance(x, dict):
            return {k: _tolist(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [_tolist(v) for v in x]
        if isinstance(x, (torch.Tensor, np.ndarray, np.floating, np.integer)):
            return x.tolist()
        return x

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fd:
        json.dump({k: _tolist(v) for k, v in tree.items()}, fd)


def hallthruster_jl(
    thruster_inputs: Optional[Dataset] = None,
    thruster="SPT-100",
    config: Optional[dict] = None,
    simulation: Optional[dict] = None,
    postprocess: Optional[dict] = None,
    model_fidelity: tuple = (2, 2),
    output_path: Optional[str] = None,
    version: Optional[str] = None,  # accepted for API parity; no Julia here
    pem_to_julia: Optional[dict] = None,
    fidelity_function: Optional[Callable] = None,
    julia_script=None,  # accepted for API parity; unused
    run_kwargs: Optional[dict] = None,  # accepted for API parity; unused
    shock_threshold: Optional[float] = None,
    device=None,
    mesh=None,
) -> Dataset:
    """PEM thruster component: batched 1-D Hall discharge simulation.

    Every entry of ``thruster_inputs`` may be a (batch,) tensor; the whole batch
    is solved in one call on ``device`` (a CUDA device unless ``"cpu"`` is
    given). With a ``mesh`` (a :class:`~hallthrusterpem_tpu_torch.parallel.mesh.Mesh`,
    which ``BatchExecutor.run`` passes) the input tree and its config (grid,
    time step) are still built once from the whole batch and only the solve is
    sharded over the mesh's devices, so the outputs are those of the unsharded
    call, on the mesh's first device unless ``device`` names another.
    Non-physical samples come back as NaN rows: negative thrust, beam
    current, discharge current or mass efficiency; a beam current above
    1.5 Z e mdot / m_i; a time-averaged discharge current outside
    [0.2, 8] e mdot / m_i when the averaging window starts at or after 0.2 ms; an
    ion-velocity peak upstream of ``shock_threshold``; a non-finite thrust.
    """
    device = resolve_device(device if device is not None or mesh is None else mesh.devices[0])
    _map = copy.deepcopy(PEM_TO_JULIA)
    if pem_to_julia is not None:
        _map.update(pem_to_julia)

    tree = format_input_tree(
        dict(thruster_inputs or {}), _map, thruster=thruster, config=config,
        simulation=simulation, postprocess=postprocess, model_fidelity=model_fidelity,
        fidelity_function=fidelity_function,
    )
    if output_path is not None:
        fname = "hallthruster_jl"
        if name := tree["config"].get("thruster", {}).get("name"):
            fname += f"_{name}"
        fname += f"_{int(time.time() * 1e6) % 2**31:x}.json"
        tree["postprocess"]["output_file"] = str((Path(output_path) / fname).resolve())

    t1 = time.time()
    sim_results = run_simulation(tree, device=device, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.time()

    outputs = {k: torch.as_tensor(v, device=device) for k, v in convert_to_pem(sim_results, _map).items()}

    thrust = outputs.get("T", torch.zeros((), device=device))
    beam = outputs.get("I_B0", torch.zeros((), device=device))
    bad = (thrust < 0) | (beam < 0)
    if "I_d" in outputs:
        bad = bad | (outputs["I_d"] < 0)
    if "eta_m" in outputs:
        bad = bad | (outputs["eta_m"] < 0)
    # the beam current cannot exceed the fully-stripped mass-flow limit
    # Z e mdot / m_i (x1.5 margin for ingestion and averaging noise)
    mdot_any = tree.get("config", {}).get("anode_mass_flow_rate")
    if mdot_any is not None and "I_B0" in outputs:
        mi = atomic_mass_kg(tree["config"].get("propellant", "Xenon"))
        zmax = int(_extreme(tree["config"].get("ncharge", 3), largest=True))
        i_eq = FUNDAMENTAL_CHARGE * torch.as_tensor(mdot_any, dtype=torch.float64, device=device) / mi
        bad = bad | (outputs["I_B0"] > 1.5 * zmax * i_eq)
        # a self-sustained discharge carries (time-averaged) between ~0.2 and ~8
        # times e mdot / m_i; judged only on quasi-steady averages, whose window
        # starts after the ~0.1-0.2 ms ignition transient
        avg_start = float(tree.get("postprocess", {}).get("average_start_time", 0.0) or 0.0)
        if "I_d" in outputs and avg_start >= 2e-4:
            i_d = outputs["I_d"]
            bad = bad | (i_d < 0.2 * i_eq) | (i_d > 8.0 * i_eq)
    if shock_threshold is not None and "u_ion" in outputs:
        ui = outputs["u_ion"]
        z = torch.broadcast_to(outputs["u_ion_coords"], ui.shape)
        z_peak = torch.gather(z, -1, torch.argmax(ui, dim=-1, keepdim=True))[..., 0]
        bad = bad | (z_peak < shock_threshold)
    bad = ~torch.isfinite(thrust) | bad
    if bool(bad.any()):
        # as in the JAX package: once any row is masked, every output is float64
        for key, val in outputs.items():
            val = val.to(torch.float64)
            mask = bad.reshape(bad.shape + (1,) * (val.ndim - bad.ndim))
            outputs[key] = torch.where(mask, torch.nan, val)

    batch_n = max(int(np.prod(tuple(thrust.shape))), 1)
    outputs["model_cost"] = torch.full(tuple(thrust.shape), (t2 - t1) / batch_n, dtype=torch.float64,
                                       device=device)
    if output_path is not None:
        out_file = Path(tree["postprocess"]["output_file"])
        outputs["output_path"] = out_file.relative_to(Path(output_path).resolve()).as_posix()
    outputs["thruster_output"] = sim_results
    return outputs
