"""The Thruster component's host time a call outside its launch loop, read
from the program's spans: the host ms inside ``htpem.call_model.Thruster``
covered neither by ``htpem.thruster.launches`` nor by a span where the host
waits for the card (``htpem.wait.*``). That is the input tree, the time step,
the solver's set-up, the time averages, the output tree and the guards; the
mean over the traced window's completed calls. None where the program keeps no
spans (:mod:`pembench.program`)."""

from pembench import program


def read(ctx):
    calls = program.call_spans(ctx)
    if not calls:
        return None
    outside = (program.host_outside(s, program.THRUSTER, program.LAUNCHES, program.WAIT) for s in calls)
    return sum(outside) * 1e-6 / len(calls)
