"""Simulated milliseconds of every completed call's rows per wall second:
rows x simulated ms, summed over the calls, over the wall from the window's
start to the end of the last completed call (finite rows or not)."""


def read(ctx):
    done = [c for c in ctx["calls"] if c["ok"]]
    return sum(c["rows"] * c["sim_ms"] for c in done) / ctx["window_wall_s"] if done else None
