"""A test-only operation (see ``pembench/run.py`` for the contract): a seeded
two-layer MLP in float32, the shape of an operation whose call is not the true
model's ``System.predict``. Its traffic, kernels, least time, check numbers,
control and outer span are its own. The tests put it in a copied tree as
``pembench/operations/mlp_test.py``, with its reference (``mlp_reference.py``),
configuration, traffic, limits and cells, and run that tree's ``run.py`` and
``control.py`` on it.

- configuration (``doc``): ``{"operation", "reference", "widths": [inputs,
  hidden, outputs], "peaks": {card name: [flop/s, bytes/s]}}``; ``peaks`` adds
  to :data:`pembench.work.PEAKS`, so that a CPU run has a least time;
- traffic (``mix``): ``{"rows_per_call"}``; call k's rows are standard normal,
  drawn from the seed and k;
- the weights are the reference's, drawn from the seed; the program runs them
  in float32 on the device (``addmm``, ``tanh``, ``addmm``) inside the span
  ``htpem.mlp.forward``; the reference is the same network in float64, and the
  control the reference in bfloat16;
- check numbers: ``output_gap`` (the widest gap over the rows compared, as a
  share of the largest reference output) and ``nonfinite_mismatch``.

:func:`read` is the reader of the per-layer metric ``mlp_forward_ms``: the
host ms inside the outer span ``htpem.mlp.forward``, a completed call's mean.
"""

from __future__ import annotations

import numpy as np
import torch

from pembench import program, work

OUTER = "htpem.mlp.forward"


def tiny(doc: dict) -> dict:
    return doc


class Operation:
    kernels = ("gemm",)
    numbers = ("output_gap", "nonfinite_mismatch")
    line_keys = ("widths",)
    sides = ("control",)
    faults = {}

    def __init__(self, spec: dict, seed: int, device: torch.device):
        from hallthrusterpem_tpu_torch import tracing

        self._span, self.device, self.seed = tracing.span, device, int(seed)
        self.doc, self.reference = spec["doc"], spec["reference"]
        self.widths = self.doc["widths"]
        self.rows_per_call = int(spec["mix"]["rows_per_call"])
        self.per_call = {}
        self.layers = self.reference.weights(self.widths, self.seed)
        self._on_device = [(torch.as_tensor(w, dtype=torch.float32, device=device),
                            torch.as_tensor(b, dtype=torch.float32, device=device)) for w, b in self.layers]
        self._calls, self._kept = 0, None

    def inputs(self, k: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 1, k + 1_000_000])
        return rng.standard_normal((self.rows_per_call, self.widths[0])).astype(np.float32)

    def call(self, x: np.ndarray) -> torch.Tensor:
        with self._span("mlp.forward"):
            h = torch.as_tensor(x, device=self.device)
            for i, (w, b) in enumerate(self._on_device):
                h = torch.addmm(b, h, w)
                h = h.tanh() if i < len(self._on_device) - 1 else h
            self._calls += 1
            return h

    def counters(self) -> dict:
        return {"calls": self._calls}

    def done(self, k: int, out: torch.Tensor, keep: bool) -> None:
        if keep:
            self._kept = (k, out)

    def least_seconds(self, k: int, device_name: str):
        peaks = {**work.PEAKS, **{n: tuple(p) for n, p in self.doc.get("peaks", {}).items()}}
        if device_name not in peaks:
            return None
        flops, bandwidth = peaks[device_name]
        macs = sum(a * b for a, b in zip(self.widths[:-1], self.widths[1:]))
        moved = 4 * (sum(a * b + b for a, b in zip(self.widths[:-1], self.widths[1:]))
                     + self.rows_per_call * (self.widths[0] + self.widths[-1]))
        return max(2 * self.rows_per_call * macs / flops, moved / bandwidth)

    def kept(self, sample):
        if self._kept is None:
            return None
        k, out = self._kept
        self._kept = None
        return k, {"y": out.detach().to("cpu", torch.float64).numpy()[sample]}

    def expected(self, k: int, sample, side: str = "reference") -> dict:
        dtype = torch.bfloat16 if side == "control" else torch.float64
        return {"y": self.reference.forward(self.layers, self.inputs(k)[sample], dtype)}

    def readings(self, got: dict, ref: dict) -> dict:
        got, ref = got["y"], ref["y"]
        finite_got, finite_ref = np.isfinite(got).all(axis=1), np.isfinite(ref).all(axis=1)
        both = finite_got & finite_ref
        gap = np.abs(got[both] - ref[both]).max() / np.abs(ref[both]).max() if both.any() else float("nan")
        return {"output_gap": float(gap), "nonfinite_mismatch": float(np.mean(finite_got != finite_ref))}

    def line(self, calls: list, numbers: dict) -> dict:
        return {"widths": self.widths}


def read(ctx):
    calls = program.call_spans(ctx, OUTER)
    if not calls:
        return None
    return sum(program.host_outside(s, OUTER) for s in calls) * 1e-6 / len(calls)
