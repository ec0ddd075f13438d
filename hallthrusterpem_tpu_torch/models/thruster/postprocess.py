"""Trace post-processing: breathing-cycle-aware time averaging (the JAX
package's ``models/thruster/postprocess.py``).

The discharge breathes (a ~10-30 kHz ionization limit cycle for the SPT-100), so
a fixed averaging window cuts the last cycle at an arbitrary phase. Averaging
between the first and last upward mean crossings of the I_d(t) trace integrates
over a whole number of cycles and removes that phase noise
(``postprocess.cycle_average``).
"""

from __future__ import annotations

import torch

__all__ = ["cycle_averaged_current"]


def cycle_averaged_current(trace, times, t_start: float) -> torch.Tensor:
    """Cycle-aligned mean of a discharge-current trace.

    :param trace: (..., n) I_d(t) samples (NaN rows propagate to NaN)
    :param times: (n,) or (..., n) sample times
    :param t_start: start of the averaging window (``cfg.average_start_time``)
    :returns: (...,) mean between the first and last upward crossings of the
        window mean (a whole number of breathing cycles), or the plain window
        mean when there are fewer than two crossings.
    """
    x = torch.as_tensor(trace)
    t = torch.broadcast_to(torch.as_tensor(times, device=x.device), x.shape)
    w = (t >= t_start).to(x.dtype)
    n_w = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    win_mean = torch.sum(x * w, dim=-1) / n_w

    d = x - win_mean[..., None]
    # upward mean crossing between samples i and i+1 (both inside the window)
    up = (d[..., :-1] <= 0) & (d[..., 1:] > 0) & (w[..., :-1] > 0) & (w[..., 1:] > 0)
    n = x.shape[-1]
    idx = torch.arange(n - 1, device=x.device)
    first = torch.amin(torch.where(up, idx, n + 1), dim=-1) + 1  # first sample past the first crossing
    last = torch.amax(torch.where(up, idx, -1), dim=-1) + 1  # first sample past the last crossing
    j = torch.arange(n, device=x.device)
    cw = ((j >= first[..., None]) & (j < last[..., None])).to(x.dtype)
    n_c = torch.clamp(torch.sum(cw, dim=-1), min=1.0)
    cyc_mean = torch.sum(x * cw, dim=-1) / n_c

    n_up = torch.sum(up, dim=-1)
    return torch.where(n_up >= 2, cyc_mean, win_mean)
