"""The card's idle share of the traced window: one minus the union of its
kernel, copy and set intervals over the window's length."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
