"""Spans and counters of the port.

``span(name)`` marks a stage of a call while a profiler runs; otherwise it is
one shared no-op context and costs one read of the profiler's flag. A span
opens ``htpem.<name>`` as an operator event on ``torch.profiler``'s host
timeline, beside the card's own events. It is not a ``record_function`` user
annotation, which the profiler copies onto the card's timeline as if the card
were busy for its whole length. When it closes it also appends to :data:`spans`
its name, its host interval on ``time.perf_counter_ns``'s clock and the change
of :data:`counts` over it, so that a reader can put each span against calls
timed on ``time.perf_counter`` once the profiler has stopped. Spans named
``htpem.wait.<place>`` cover the points where the host blocks on the card.

``counts`` holds plain integers that the program adds to whether or not a
profiler runs, through :func:`count`:

- ``kstep_host_ns``, ``kstep_blocks``: host nanoseconds spent in
  ``fused_step.kstep``, entry to return, and the calls so timed (a call made
  while its thread captures a CUDA graph is not timed);
- ``rows_attempted``, ``rows_masked``: the rows ``hallthruster_jl`` was given
  and those its guards masked as non-physical;
- ``plume_kernel_rows``, ``plume_eager_rows``: the rows ``models.plume.current_density``
  computed by its CUDA kernel (inputs on a card) and by its eager plain
  version (inputs on the CPU);
- ``gaussian_bohm_rows``: the rows of each GaussianBohm anomalous-transport
  profile ``solver.anomalous_profile`` builds (once a call on the K-step route,
  in ``fused_step.pack_consts``; on the lax route once for the initial state,
  once a segment and once for the time averages); 0 for a TwoZoneBohm
  configuration.

Spans of the Thruster's solve on the K-step route (``fused_step``):
``htpem.thruster.init`` (the initial carry), inside it ``htpem.thruster.consts``
(``pack_consts``: the anomalous-transport profile with its pressure shift, the
field and the per-row scalar block), then ``htpem.thruster.launches`` and
``htpem.thruster.average``.

A span's counter change includes what other host threads added meanwhile.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["span", "spans", "counts", "count", "reset_counts"]

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
counts = {"kstep_host_ns": 0, "kstep_blocks": 0, "rows_attempted": 0, "rows_masked": 0,
          "plume_kernel_rows": 0, "plume_eager_rows": 0, "gaussian_bohm_rows": 0}
#: (name, start_ns, end_ns, {counter: change}) of the latest spans closed while a profiler ran
spans = collections.deque(maxlen=1 << 16)


class _Span:
    __slots__ = ("name", "_event", "_t0", "_c0")

    def __init__(self, name: str):
        self.name = "htpem." + name
        self._event = torch._C._profiler._RecordFunctionFast(self.name)

    def __enter__(self):
        self._event.__enter__()
        self._c0 = dict(counts)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        changed = {k: n - self._c0[k] for k, n in counts.items() if n != self._c0[k]}
        spans.append((self.name, self._t0, t1, changed))
        self._event.__exit__(*exc)
        return False


def span(name: str):
    """The span ``htpem.<name>`` while a profiler runs, else a shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(**deltas: int) -> None:
    """Add to :data:`counts` under its lock (one host thread per card may add)."""
    with _lock:
        for name, n in deltas.items():
            counts[name] += n


def reset_counts() -> None:
    with _lock:
        for name in counts:
            counts[name] = 0
