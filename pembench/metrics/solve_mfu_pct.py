"""The coupled solve's share of the card's peak: the least time of the work
of every completed call over the window's wall. It bounds a gain whatever
kernel runs the solve."""


def read(ctx):
    done = [c for c in ctx["calls"] if c["ok"]]
    if not done or any(c["least_s"] is None for c in done):
        return None
    return 100.0 * sum(c["least_s"] for c in done) / ctx["window_wall_s"]
