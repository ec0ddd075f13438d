"""The Thruster component's time a call outside the K-step kernel: its
model_costs over the call minus the time of the card's events named
kstep_kernel inside the call (the input tree, the time step, the launch loop's
host gaps, the trace gather, the cycle average). None when no such kernel ran."""


def read(ctx):
    done = [c for c in ctx["calls"] if c["ok"] and c.get("kernel_s") is not None]
    if not done or not any(c["kernel_s"] for c in done):
        return None
    return sum(c["thruster_s"] - c["kernel_s"] for c in done) * 1e3 / len(done)
