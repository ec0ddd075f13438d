"""What the traced run reads from ``torch.profiler``: the card's busy time over
the window (the union of its kernel, copy and set intervals), each call's time
in the kernels that the operation names, the operations that took most of the
card's time, and the card's idle gaps by what the host was doing meanwhile."""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "pembench.window"
CALL = "pembench.call"


def _events(prof) -> list:
    """(name, on_device, start_ns, end_ns) of every event of the trace."""
    return [(e.name(), e.device_type().name != "CPU", e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def read(prof, kernels: tuple) -> dict:
    """The window's length and the card's busy seconds in it, each call's
    seconds in kernels whose name holds one of the substrings ``kernels``,
    and the breakdown."""
    events = _events(prof)
    host = sorted((e for e in events if not e[1]), key=lambda e: e[2])
    window = next(((s, t) for n, _, s, t in host if n == WINDOW), None)
    if window is None:
        return {}
    w0, w1 = window
    calls = [(s, t) for n, _, s, t in host if n == CALL]
    # the card's own intervals: the harness's spans are copied onto the card's timeline too
    dev = sorted((s, t, n) for n, on, s, t in events if on and t > w0 and s < w1 and not n.startswith("pembench."))
    busy, merged, by_name = 0, [], defaultdict(int)
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        by_name[name] += t - s
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    starts = [c[0] for c in calls]
    per_call = [0] * len(calls)
    for s, t, name in dev:
        if any(k in name for k in kernels):
            i = bisect.bisect_right(starts, s) - 1
            if 0 <= i < len(calls) and s <= calls[i][1]:
                per_call[i] += t - s
    gaps = defaultdict(int)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    host_starts = [e[2] for e in host]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_doing(host, host_starts, (a + b) // 2)] += b - a
    top = lambda d: [[n[:160], v * 1e-9] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9, "kernel_s": [x * 1e-9 for x in per_call],
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)}}


def _doing(host: list, starts: list, t: int) -> str:
    """The innermost host event that covers time ``t`` (the latest to start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        name, _, s, e = host[j]
        if s <= t <= e and name != WINDOW:
            return name
    return "host outside any traced event"
