"""The 90th percentile of the wall of every call in the window (host clock,
each call ended by a synchronise), linear between order statistics."""

import statistics


def read(ctx):
    walls = [c["wall_s"] * 1e3 for c in ctx["calls"]]
    return statistics.quantiles(walls, n=10, method="inclusive")[8] if len(walls) > 1 else walls[0]
