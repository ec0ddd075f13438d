"""Host time a call in the solver's per-row constants, read from the program's
spans: the host ms inside ``htpem.thruster.consts`` (``fused_step.pack_consts``:
the anomalous-transport profile with its pressure shift, the magnetic field and
the packed scalar block), the mean over the traced window's completed calls.
None where the program keeps no spans or has no such span
(:mod:`pembench.program`)."""

from pembench import program

CONSTS = "htpem.thruster.consts"


def read(ctx):
    calls = program.call_spans(ctx)
    if not calls or not any(s[0] == CONSTS for spans in calls for s in spans):
        return None
    return sum(program.host_outside(s, CONSTS) for s in calls) * 1e-6 / len(calls)
