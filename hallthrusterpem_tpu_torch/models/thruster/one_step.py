"""One-step discharge driver: one kernel launch per timestep, the time averages
accumulated in torch on the device.

Counterpart of the JAX package's ``simulate_batch_pallas`` with
``make_batch_step``, ``_pallas_init`` and ``_pallas_finalize``
(``models/thruster/pallas_step.py:1114-1282``). What this path adds over the
K-step driver (:func:`.fused_step.simulate_batch_multi`) is the all-state
``isfinite`` check after every step: a blow-up is caught on the step it happens,
not at the next launch's scrub. The K-step driver is the fast path; this one is
the step-by-step reference path that the JAX package keeps beside it.

A step reads no tensor value on the host: the step index is a 0-d tensor on the
device, the averaging weight a tensor expression of it, and every value carried
from one step to the next lives in a buffer updated in place. So on a CUDA
device the loop is captured as CUDA graphs of ``GRAPH_STEPS`` steps and
replayed (:mod:`..cuda_graph`), the counterpart of JAX's jitted ``lax.scan``
over the step kernel; on the CPU it steps eagerly.
"""

from __future__ import annotations

import torch

from hallthrusterpem_tpu_torch import cuda_graph
from hallthrusterpem_tpu_torch.constants import FUNDAMENTAL_CHARGE
from hallthrusterpem_tpu_torch.models.thruster import fused_step as fs
from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig

_E = FUNDAMENTAL_CHARGE

__all__ = ["simulate_batch_step", "GRAPH_STEPS"]

#: steps of the CUDA graph the one-step loop replays on a CUDA device
GRAPH_STEPS = 100


def simulate_batch_step(params: dict, base_B: torch.Tensor, cfg: SolverConfig,
                        chunk_steps: int = 0, block=None, graphs: bool = True) -> dict:
    """Whole time loop, one step per launch, then the time averages. Runs where
    ``params`` lie: on a CUDA device through the one-step kernel, on the CPU
    through its plain version. There is no batch padding.

    ``chunk_steps > 0`` runs the loop in whole chunks of that many steps, as the
    JAX driver's chunked dispatch does: the steps past ``num_steps`` in the last
    chunk run, are not averaged, and still mark a sample failed if they blow up.
    ``block`` replaces the step function (default :func:`.fused_step.step`);
    passing :func:`.fused_step.step_plain` runs the plain version on any device.
    On a CUDA device the kernel's loop replays CUDA graphs (:func:`_replay`);
    ``graphs=False`` steps it eagerly there, the same operators in the same
    order, for comparing the two on the card."""
    block = block or fs.step
    params = {k: v.to(torch.float32) for k, v in params.items()}
    base_B = base_B.to(device=params["V_d"].device, dtype=torch.float32)
    consts, state, prof, sacc = fs.init_carry(params, base_B, cfg)
    physics = fs.Physics(cfg) if block is fs.step_plain or state.device.type == "cpu" else None
    Z, NC, mi = cfg.ncharge, cfg.nc, cfg.mi
    A_ch = cfg.geometry.channel_area
    a_i2 = 1.380649e-23 * cfg.ion_temp_K / mi
    rho_floor = 1e10 * mi
    ex = NC - 2
    B = state.shape[1]
    extras = torch.empty((5, B, fs.lanes_for(cfg)), dtype=torch.float32, device=state.device)
    scal_icir = consts["scalars"][:, fs.P_ICIR]
    scal_icir.copy_(sacc[:, fs.A_ICIR])
    failed = torch.zeros(B, dtype=torch.bool, device=state.device)
    i = torch.zeros((), dtype=torch.int64, device=state.device)
    n_steps = cfg.num_steps
    if chunk_steps and cfg.num_steps > chunk_steps:
        n_steps = -(-cfg.num_steps // chunk_steps) * chunk_steps

    def step():
        block(state, extras, consts, cfg, physics)
        j_d, qs_t, qs_f = extras[0, :, 0], extras[0, :, 1], extras[0, :, 2]
        thrust = I_B0 = mdot_ion = 0.0
        for z in range(Z):
            r, m = state[2 + 2 * z, :, ex], state[3 + 2 * z, :, ex]
            u = m / torch.clamp(r, min=rho_floor)
            thrust = thrust + A_ch * (m * u + r * a_i2)
            I_B0 = I_B0 + (A_ch * _E * (z + 1)) * r / mi * u
            mdot_ion = mdot_ion + A_ch * m
            if z == 0:
                u_exit1 = u
        if cfg.solve_plume:
            thrust = thrust * qs_t
            I_B0 = I_B0 * qs_f
            mdot_ion = mdot_ion * qs_f
        I_d = j_d * A_ch
        # the kernel scrubs non-finite values at the next step's entry, before j_d
        # is computed, so a blow-up shows only in the raw post-step state
        failed.logical_or_(~torch.isfinite(I_d) | ~torch.isfinite(state).all(dim=2).all(dim=0))

        w = ((i >= cfg.avg_start_step) & (i < cfg.num_steps)).to(torch.float32)
        sacc[:, fs.A_THRUST] += w * thrust
        sacc[:, fs.A_ID] += w * I_d
        sacc[:, fs.A_ID2] += w * I_d * I_d
        sacc[:, fs.A_IB0] += w * I_B0
        sacc[:, fs.A_MDOT] += w * mdot_ion
        sacc[:, fs.A_UEXIT] += w * u_exit1
        prof[:Z] += w * (state[3 : 3 + 2 * Z : 2] / torch.clamp(state[2 : 2 + 2 * Z : 2], min=rho_floor))
        prof[Z:] += w * extras[1:]
        scal_icir.copy_(I_d)  # the circuit current the next step reads
        i.add_(1)

    if graphs and block is fs.step and state.device.type == "cuda":
        _replay(step, n_steps, state.device)
    else:
        for _ in range(n_steps):
            step()

    sacc[:, fs.A_FAILED] = failed.float()
    return fs.finalize(params, sacc, prof, consts, base_B, cfg)


def _repeat(step, n: int) -> None:
    for _ in range(n):
        step()


def _replay(step, n_steps: int, device) -> None:
    """``n_steps`` calls of ``step`` on a CUDA device: the first eagerly, which
    warms what a capture must not do first (the kernel's rate coefficients
    reach the card, the allocator, the lazy module loading), then replays of a
    graph of ``min(GRAPH_STEPS, n_steps - 1)`` steps and one graph of the
    remainder: exactly ``n_steps`` steps, never more (one more step can flip a
    row's failure flag). Both graphs are captured, once a call, before the
    first replay (a capture waits for the work queued before it); a capture or
    replay error is raised."""
    if n_steps <= 0:
        return
    step()
    left = n_steps - 1
    if left == 0:
        return
    size = min(GRAPH_STEPS, left)
    full, tail = divmod(left, size)
    graph = cuda_graph.capture(lambda: _repeat(step, size), device)
    tail_graph = cuda_graph.capture(lambda: _repeat(step, tail), device) if tail else None
    for _ in range(full):
        graph.replay()
    if tail_graph is not None:
        tail_graph.replay()
