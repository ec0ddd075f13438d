"""The operation ``predict``: the pem_v0 coupled system (cathode -> 1-D
discharge -> plume) through the port's ``System.predict``. A configuration
that names no ``"operation"`` runs this one.

Each call's rows come from :class:`pembench.traffic.Traffic` (the cell's mix
and ``--seed``); a call is one ``System.predict`` at the configuration's
``use_model``. Its record holds the rows, the simulated ms (the Thruster's
``duration``), the Thruster's ``model_costs`` and the K-step launches over the
call. The traced run times the kernels named ``kstep_kernel``; a call's least
time is the work :mod:`pembench.work` counts on the reference's grid. The check
compares the outputs :data:`pembench.check.COMPARED` of a sample of the checked
call's rows with :mod:`pembench.reference`'s plain version on the same rows,
by :func:`pembench.check.readings`; its control is that reference in bfloat16.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pembench import check, work
from pembench.traffic import Traffic


def tiny(doc: dict) -> dict:
    """The configuration at a size a CPU test can run: 0.4 us, 20 trace points."""
    doc = copy.deepcopy(doc)
    thr = next(c for c in doc["components"] if c["name"] == "Thruster")
    thr["simulation"].update(duration=4e-7, num_save=20)
    thr["postprocess"]["average_start_time"] = 2e-7
    return doc


def sized(system, doc: dict) -> None:
    """The loaded system at the document's sizes (the dry run's tiny ones)."""
    for comp, src in zip(system.components, doc["components"]):
        comp.model_kwargs.update({k: src[k] for k in ("simulation", "postprocess") if k in src})


def _half_rows(got: dict, rows: np.ndarray, n: int) -> dict:
    """The rows of the call's second half given the mean of its first half's."""
    late = rows >= n // 2
    out = {k: v.copy() for k, v in got.items()}
    for v in out.values():
        v[late] = np.nanmean(v[~late], axis=0)
    return out


def _one_row(got: dict, rows: np.ndarray, n: int) -> dict:
    """The first row with a discharge given the next such row's outputs, as an
    index off by one would."""
    ok = np.flatnonzero(np.isfinite(got["T"]))
    out = {k: v.copy() for k, v in got.items()}
    if len(ok) > 1:
        for v in out.values():
            v[ok[0]] = v[ok[1]]
    return out


def _one_answer(got: dict, rows: np.ndarray, n: int) -> dict:
    """The current density of the first row with a beam altered by 1%."""
    j = got["j_ion"].copy()
    j[np.flatnonzero(np.isfinite(got["I_B0"]))[:1]] *= 1.01
    return dict(got, j_ion=j)


class Operation:
    #: the kernels whose time on the card the traced run gives each call
    kernels = ("kstep_kernel",)
    #: the numbers the check compares, each of which the cell's limits file names
    numbers = check.NUMBERS
    #: the keys :meth:`line` adds to the line's ``calls`` object
    line_keys = ("kstep_launches_per_call", "nonfinite_share_per_call", "widest_row_gap", "kernel_build")
    #: the sides :meth:`expected` computes besides the reference: the reference in
    #: bfloat16, the precision below the configuration's float32, and the reference
    #: with the input ``a_1`` one float32 step up (how far rounding alone moves it)
    sides = ("control", "perturbed")
    #: faults planted in the program's compared outputs (``pembench/control.py``)
    faults = {"half the rows": _half_rows, "a row from another": _one_row, "one answer altered": _one_answer}

    def __init__(self, spec: dict, seed: int, device: torch.device):
        from hallthrusterpem_tpu_torch.core.json_loader import load_system
        from hallthrusterpem_tpu_torch.models.thruster import _kernels

        self._kernels, self.device = _kernels, device
        self.doc, self.limits, self.reference = spec["doc"], spec["limits"], spec["reference"]
        self.use_model = self.doc["use_model"]
        self.system = load_system(spec["config_file"], device=device)
        cpu = device.type == "cpu"
        if cpu:
            sized(self.system, self.doc)
        self.traffic = Traffic(self.doc, spec["mix"], seed)
        self.rows_per_call = min(self.traffic.rows, 4) if cpu else self.traffic.rows
        thruster = next(c for c in self.doc["components"] if c["name"] == "Thruster")
        self.per_call = {"sim_ms": float(thruster["simulation"]["duration"]) * 1e3}
        self._thruster = self.system["Thruster"]
        self._thrust, self._kept = [], None

    def inputs(self, k: int) -> dict:
        return {n: v[:self.rows_per_call] for n, v in self.traffic.call(k).items()}

    def call(self, rows: dict) -> dict:
        return self.system.predict(rows, use_model=self.use_model)

    def counters(self) -> dict:
        return {"thruster_s": sum(t for _, t in self._thruster.model_costs.values()),
                "launches": self._kernels.launch_counts["kstep"]}

    def done(self, k: int, out: dict, keep: bool) -> None:
        self._thrust.append(out["T"])  # its nonfinite share is read after the window, with no sync in it
        if keep:
            self._kept = (k, {n: out[n] for n in check.COMPARED})

    def least_seconds(self, k: int, device_name: str):
        g = self.reference.grid_for(self.doc, self.inputs(k), self.use_model)
        return work.least_seconds(self.doc["work"], self.rows_per_call, g, device_name)

    def kept(self, sample: np.ndarray):
        if self._kept is None:
            return None
        k, outputs = self._kept
        self._kept = None
        got = {n: torch.as_tensor(outputs[n]).detach().to("cpu", torch.float64).numpy()[sample]
               for n in check.COMPARED}
        del outputs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return k, got

    def expected(self, k: int, sample: np.ndarray, side: str = "reference") -> dict:
        rows = self.inputs(k)
        part = {n: v[sample] for n, v in rows.items()}
        if side == "perturbed":
            part = dict(part, a_1=np.nextafter(part["a_1"], np.float32(np.inf)))
        dtype = torch.bfloat16 if side == "control" else torch.float32
        return self.reference.predict(self.doc, part, self.use_model, dtype, self.device, batch=rows)

    def readings(self, got: dict, ref: dict) -> dict:
        return check.readings(got, ref, self.limits["trace_points"])

    def line(self, calls: list, numbers: dict) -> dict:
        nonfinite = [float(1.0 - torch.isfinite(t).float().mean()) for t in self._thrust]
        self._thrust = []
        return {"kstep_launches_per_call": [min(c["launches"] for c in calls), max(c["launches"] for c in calls)],
                "nonfinite_share_per_call": [min(nonfinite), sum(nonfinite) / len(nonfinite), max(nonfinite)]
                if nonfinite else None,
                "widest_row_gap": numbers.get("widest"),
                "kernel_build": {n: {"seconds": b.get("seconds"), "cached": b.get("cached")}
                                 for n, b in self._kernels.build_info.items()}}
