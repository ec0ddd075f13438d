"""Host microseconds a K-step block: the program's counter kstep_host_ns over
kstep_blocks (``fused_step.kstep``, entry to return, the kernel's launch on the
card), their changes over the ``htpem.predict`` spans of the traced window's
completed calls. None where the program keeps no spans or ran no block
(:mod:`pembench.program`)."""

from pembench import program


def read(ctx):
    calls = program.call_spans(ctx) or []
    blocks = program.counted(calls, "kstep_blocks")
    return program.counted(calls, "kstep_host_ns") * 1e-3 / blocks if blocks else None
