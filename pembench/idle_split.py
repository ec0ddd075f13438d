"""A traced run of a cell that also splits the card's idle time by the
program's spans (``htpem.*`` operator events on the profiler's host timeline):

    python3 pembench/idle_split.py --workload <cell> --seed <n> --seconds <s> --trace 1

It runs ``pembench/run.py`` with the same arguments, which prints its line,
then prints one more JSON line: ``idle_split_s``, the card's idle seconds in
the window (one minus the union of the intervals that ``trace.read`` counts as
busy) inside a ``htpem.thruster.launches`` span, inside another program span,
and outside every program span (the harness between calls); ``launch_idle_ms``,
the first of these a completed call; ``program_events_on_card``, the program's
events that the profiler put on the card's timeline (none: they would count as
busy time)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pembench import program, run, trace  # noqa: E402

PREFIX = "htpem."


def idle_split(events: list) -> dict:
    """The split of the window's idle time, from ``trace._events``'s list."""
    host = [e for e in events if not e[1]]
    window = next(((s, t) for n, _, s, t in host if n == trace.WINDOW), None)
    if window is None:
        return {}
    w0, w1 = window
    busy = program.merge((max(s, w0), min(t, w1)) for n, on, s, t in events
                         if on and t > w0 and s < w1 and not n.startswith("pembench."))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    loops = program.merge((s, t) for n, _, s, t in host if n == program.LAUNCHES)
    spans = program.merge((s, t) for n, _, s, t in host if n.startswith(PREFIX))
    in_loops, in_spans = overlap(idle, loops), overlap(idle, spans)
    calls = sum(1 for n, _, _, _ in host if n == trace.CALL)
    return {"idle_split_s": {"launch_loops": in_loops * 1e-9,
                             "other_program_spans": (in_spans - in_loops) * 1e-9,
                             "outside_program_spans": (sum(b - a for a, b in idle) - in_spans) * 1e-9},
            "launch_idle_ms": in_loops * 1e-6 / calls if calls else None,
            "program_events_on_card": sum(1 for n, on, _, _ in events if on and n.startswith(PREFIX))}


def overlap(a: list, b: list) -> int:
    """The ns where two sorted lists of disjoint intervals overlap."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def main(argv=None) -> int:
    found = {}
    read = trace.read

    def read_and_split(prof, kernels):
        events = trace._events(prof)
        found.update(idle_split(events))
        return read(prof, kernels)

    trace.read = read_and_split
    rc = run.main(argv)
    print(json.dumps(found), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
