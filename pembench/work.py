"""The work of a call and the least time the card could take for it.

The operations of the discharge are counted once, on the plain reference's
step (:mod:`pembench.reference`), as one operation per output element of each
arithmetic operator, on a layout with one lane per cell and ghost cell (no
padding lanes): the set-up of a call (parameters, profiles, initial state), a
step that only advances the state, and a step whose values join the running
sums. A configuration file stores the three counts per row under ``work``;
:func:`count_config` computes them again (``pembench/tests`` holds the two
equal). A call of ``rows`` rows and the grid ``g`` then needs

    rows * (setup + steps_before_average * step + steps_averaged * step_acc)

operations, whatever kernel runs them, however many launches or steps a launch
take. Its bytes are each input of a row read once and each compared output
written once (float32). The least time is the larger of the operations over
the card's float32 rate and the bytes over its memory rate (NVIDIA's data
sheet, SXM part, at its 700 W limit).
"""

from __future__ import annotations

import torch

#: device name -> (float32 operations a second outside the tensor cores, memory bytes a second)
PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 3.35e12)}

_ARITH = {"add", "sub", "mul", "div", "neg", "exp", "log", "log1p", "sqrt", "rsqrt", "reciprocal",
          "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "where", "sign", "abs", "pow", "lt",
          "le", "gt", "ge", "eq", "ne", "isfinite", "logical_not", "logical_or", "logical_and",
          "bitwise_or", "bitwise_and", "bitwise_not", "any", "all", "sum", "rsub", "tanh", "sigmoid",
          "sin", "cos", "acos"}


def count_ops(fn) -> int:
    """Operations of ``fn()``: one per output element (or per input element,
    whichever is more) of every arithmetic operator it dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in _ARITH:
                numel = max((a.numel() for a in args if isinstance(a, torch.Tensor)), default=1)
                Counter.n += max(numel, out.numel() if isinstance(out, torch.Tensor) else 1)
            return out

    with Counter():
        fn()
    return Counter.n


def count_config(doc: dict, reference, use_model: str, rows: dict) -> dict:
    """Per-row operations of the discharge for the configuration ``doc``,
    counted on ``reference``'s step with one lane per cell, from the first two
    and three of ``rows``: the difference is a row's share (the set-up also
    interpolates the field once a call). The counts do not depend on the rows'
    values."""
    g = reference.grid_for(doc, rows, use_model)
    counts = []
    for n in (2, 3):
        part = {k: v[:n] for k, v in rows.items()}
        made = []
        setup = count_ops(lambda: made.append(
            reference.discharge(doc, part, use_model, torch.float32, "cpu", lanes=g.nc, batch=rows)))
        counts.append((setup, count_ops(lambda: made[0].step(False)), count_ops(lambda: made[0].step(True))))
    setup, step, acc = (b - a for a, b in zip(*counts))
    # the scalar outputs, then the u_ion profile, the j_ion sweep and the I_d(t) trace
    outputs = sum(len(v) for v in reference.OUTPUTS.values()) - 3 + g.nc + reference.PLUME_ANGLES + g.num_save
    return {"lanes": g.nc, "setup_per_row": setup, "step_per_row": step, "step_averaged_per_row": acc,
            "bytes_per_row": 4 * (len(rows) + outputs)}


def call_ops(work: dict, rows: int, g) -> float:
    averaged = g.num_steps - g.avg_start_step
    return rows * (work["setup_per_row"] + g.avg_start_step * work["step_per_row"]
                   + averaged * work["step_averaged_per_row"])


def least_seconds(work: dict, rows: int, g, device_name: str):
    """The least time of one call on the card ``device_name``, or None where
    the card has no entry in :data:`PEAKS`."""
    if device_name not in PEAKS:
        return None
    flops, bandwidth = PEAKS[device_name]
    return max(call_ops(work, rows, g) / flops, rows * work["bytes_per_row"] / bandwidth)
