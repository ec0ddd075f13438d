"""CUDA graphs: the port's counterpart of ``jax.jit`` for a program of many small
operators (the lax solver's step loop, the one-step driver's loop over the step
kernel, the device posterior of ``scripts/pem_v0/mcmc.py``).

:func:`capture` records a function's launches once; :meth:`Graph.replay` runs
them again with one host call, on the caller's current stream. Every program of
the port that replays graphs captures them the same way:

- on a stream of its own, after ``warmup()`` there (lazy module loading, the
  caching allocator, a library's per-stream state);
- in the thread-local capture mode and one capture at a time (PyTorch
  registers its generators with one capture at a time), so that several host
  threads may capture and replay side by side;
- a kernel wrapper counts its launches through :func:`count`: a launch made
  under a capture runs only when the graph is replayed, so it is kept with the
  graph and counted again at each replay.

A capture or replay error is raised; nothing falls back to running eagerly.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

__all__ = ["Graph", "capture", "count"]

_CAPTURE_LOCK = threading.Lock()
_local = threading.local()


def count(counts: dict, name: str, lock: threading.Lock) -> None:
    """One launch of kernel ``name``: ``counts[name] += 1`` under ``lock``, or,
    while this thread captures a graph, one launch more at each of its replays."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        key = (id(counts), name)
        n = tally[key][3] if key in tally else 0
        tally[key] = (counts, name, lock, n + 1)
        return
    with lock:
        counts[name] += 1


class Graph:
    """A captured CUDA graph, the output of the captured function (its tensors
    are rewritten in place by each replay) and the kernel launches it holds."""

    def __init__(self, graph: torch.cuda.CUDAGraph, tally: dict, output):
        self._graph, self._tally, self.output = graph, list(tally.values()), output
        #: kernel name -> launches a replay makes
        self.launches = {name: n for _, name, _, n in self._tally}

    def replay(self) -> None:
        self._graph.replay()
        for counts, name, lock, n in self._tally:
            with lock:
                counts[name] += n


def capture(body: Callable, device, warmup: Optional[Callable] = None) -> Graph:
    """Capture ``body()`` on ``device`` into a :class:`Graph`, after
    ``warmup()`` (if any) on the capture's stream; see the module's note."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    tally: dict = {}
    with torch.cuda.stream(side):
        if warmup is not None:
            warmup()
        side.synchronize()
        with _CAPTURE_LOCK:
            graph.capture_begin(capture_error_mode="thread_local")
            _local.tally = tally
            try:
                out = body()
            finally:
                _local.tally = None
                graph.capture_end()
    return Graph(graph, tally, out)
