"""The System layer's host time a call, read from the program's spans: the
host ms inside ``htpem.predict`` covered neither by the Thruster component's
``htpem.call_model.Thruster`` nor by a span where the host waits for the card
(``htpem.wait.*``). That is the cathode, the plume and the System's
bookkeeping; the mean over the traced window's completed calls. None where the
program keeps no spans (:mod:`pembench.program`)."""

from pembench import program


def read(ctx):
    calls = program.call_spans(ctx)
    if not calls:
        return None
    outside = (program.host_outside(s, program.PREDICT, program.THRUSTER, program.WAIT) for s in calls)
    return sum(outside) * 1e-6 / len(calls)
