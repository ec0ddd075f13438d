"""Monte Carlo forward UQ over a coupled System (the JAX package's
``uq/montecarlo.py``): sample the inputs, push them through the surrogate or the
model on the system's device, summarize on the host."""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from hallthrusterpem_tpu_torch.core.dataset import to_numpy
from hallthrusterpem_tpu_torch.surrogate.train import relative_l2

__all__ = ["run_mc", "mc_percentiles", "l2_error_table"]


def run_mc(
    system,
    n_samples: int,
    use_model: Optional[str] = None,
    use_pdf: Iterable[str] | bool = ("calibration", "nuisance"),
    nominal: Optional[dict] = None,
    constants: Iterable[str] = (),
    qois: Optional[Iterable[str]] = None,
    seed: int = 0,
    normalize: bool = False,
    generator: Optional[torch.Generator] = None,
) -> tuple[dict, dict]:
    """Sample inputs (``System.sample_inputs``, from ``generator`` or one seeded
    with ``seed``) and push them through the system (the surrogate by default).

    :returns: (samples, outputs) dicts of (n_samples, ...) tensors on the
        system's device
    """
    samples = system.sample_inputs(
        n_samples, generator=generator, seed=seed, use_pdf=use_pdf, nominal=nominal,
        constants=constants, normalize=normalize,
    )
    outputs = system.predict(samples, use_model=use_model, normalized=normalize, qoi_ind=qois)
    return samples, outputs


def mc_percentiles(outputs: dict, percentiles=(5, 50, 95)) -> dict:
    """NaN-robust percentile table per output, computed in numpy on the host
    (failed samples are NaN rows)."""
    out = {}
    for k, v in outputs.items():
        arr = np.asarray(to_numpy(v), dtype=np.float64)
        out[k] = {p: np.nanpercentile(arr, p, axis=0) for p in percentiles}
    return out


def l2_error_table(pred: dict, truth: dict, qois: Optional[Iterable[str]] = None) -> dict:
    """Relative-L2 error of ``pred`` against ``truth`` per output of the same
    shape (per-sample mean for fields)."""
    table = {}
    for k in qois or truth.keys():
        if k in pred and k in truth:
            p = np.asarray(to_numpy(pred[k]), dtype=np.float64)
            t = np.asarray(to_numpy(truth[k]), dtype=np.float64)
            if p.shape == t.shape:
                table[k] = relative_l2(p, t, axis=-1 if t.ndim > 1 else None)
    return table
