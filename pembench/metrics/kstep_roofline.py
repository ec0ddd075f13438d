"""The K-step kernel's share of its roofline: the least time of the traced
calls' work (pembench.work: operations counted once on the plain reference,
bytes read and written once a call) over the summed time of the card's events
named kstep_kernel. None when no such kernel ran or the card has no peaks."""


def read(ctx):
    done = [c for c in ctx["calls"] if c["ok"] and c.get("kernel_s") is not None]
    kernel = sum(c["kernel_s"] for c in done)
    if not kernel or any(c["least_s"] is None for c in done):
        return None
    return 100.0 * sum(c["least_s"] for c in done) / kernel
