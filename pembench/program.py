"""What the program records of its own calls while the traced window's profiler
runs (``hallthrusterpem_tpu_torch.tracing.spans``): each span's name, its host
interval on ``time.perf_counter_ns``'s clock and the change of the program's
counters over it. The harness times each call on ``time.perf_counter``, the
same clock, so a span belongs to the call whose interval holds it.

A program without that record (as before it had spans) gives None, and the
metrics that read it are left out of the line."""

from __future__ import annotations

import bisect
import sys

MODULE = "hallthrusterpem_tpu_torch.tracing"
PREDICT = "htpem.predict"
THRUSTER = "htpem.call_model.Thruster"
LAUNCHES = "htpem.thruster.launches"
WAIT = "htpem.wait."
#: slack, in ns, of a call's bounds: the harness reads them as float seconds
SLACK_NS = 1000


def call_spans(ctx: dict, outer: str = PREDICT) -> list | None:
    """The spans of each completed call of the window that holds a span named
    ``outer`` (the span of the program's entry that the call drives), as lists
    of (name, start_ns, end_ns, counter changes); None where the program keeps
    no such record or no call has one."""
    record = getattr(sys.modules.get(MODULE), "spans", None)
    if record is None:
        return None
    held = sorted(record, key=lambda s: s[1])
    starts = [s[1] for s in held]
    out = []
    for c in ctx["calls"]:
        if not c["ok"]:
            continue
        a, b = round((c["end"] - c["wall_s"]) * 1e9) - SLACK_NS, round(c["end"] * 1e9) + SLACK_NS
        inside = [s for s in held[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)] if s[2] <= b]
        if any(s[0] == outer for s in inside):
            out.append(inside)
    return out or None


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint ``[start, end]``."""
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def host_outside(spans: list, outer: str, *excluded: str) -> int:
    """Host ns inside the spans named ``outer`` not covered by any span whose
    name is one of ``excluded`` or, for one ending in a dot, starts with it."""
    hit = lambda n: any(n.startswith(e) if e.endswith(".") else n == e for e in excluded)
    total = 0
    for _, a, b, _ in (s for s in spans if s[0] == outer):
        covered = merge((max(s, a), min(t, b)) for n, s, t, _ in spans if hit(n) and s < b and t > a)
        total += (b - a) - sum(t - s for s, t in covered)
    return total


def counted(calls: list, name: str) -> int:
    """A counter's change over the ``htpem.predict`` spans of the calls."""
    return sum(d.get(name, 0) for spans in calls for n, _, _, d in spans if n == PREDICT)
