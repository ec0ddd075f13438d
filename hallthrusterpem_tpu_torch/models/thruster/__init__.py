"""1-D Hall discharge solver of the port: configuration, B-field loading and the
K-step time loop (:mod:`.fused_step`) around the hand-written CUDA kernel."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from hallthrusterpem_tpu_torch.models.thruster.config import SolverConfig
from hallthrusterpem_tpu_torch.ops.interp import interp1d


def _load_bfield(thr: dict, cfg: SolverConfig) -> np.ndarray:
    """Magnetic-field profile [T] on the solver's cell centres from a device dict,
    interpolated in float32 as the JAX package does. Raises if the device names
    no field file or the file is missing."""
    file = (thr or {}).get("magnetic_field", {}).get("file")
    if not file or not Path(str(file)).exists():
        raise FileNotFoundError(f"magnetic-field file of the device not found: {file!r}")
    raw = np.genfromtxt(str(file), delimiter=",", skip_header=1)
    if raw.ndim == 1 or raw.shape[1] < 2:  # maybe headerless
        raw = np.genfromtxt(str(file), delimiter=",")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return interp1d(f32(cfg.cell_centers()), f32(raw[:, 0]), f32(raw[:, 1])).numpy()
