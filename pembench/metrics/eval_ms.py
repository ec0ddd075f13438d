"""The window's wall over the number of calls completed: the mean time a
posterior evaluation waits for its call."""


def read(ctx):
    done = sum(c["ok"] for c in ctx["calls"])
    return ctx["window_wall_s"] * 1e3 / done if done else None
