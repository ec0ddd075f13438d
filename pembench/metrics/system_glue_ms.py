"""The System layer's own time a call: the call's wall (a span of the harness
around System.predict, ended by a synchronise) minus the Thruster component's
model_costs over that call. That is the cathode, the plume and the System's
bookkeeping; the mean over the traced calls."""


def read(ctx):
    done = [c for c in ctx["calls"] if c["ok"]]
    return sum(c["wall_s"] - c["thruster_s"] for c in done) * 1e3 / len(done) if done else None
